"""The port against the reference at the main path's width, D = 960 (the
GIST1M shape), on the CPU.

The reference's fused executors lose neighbours at int4 by their own
semantics: an exact START threshold against int4-dequantized partial
distances prunes most lanes after one d-tile (fused-scan), and the top
``rerank_mult * k`` int4 candidates miss true neighbours (fused-batch).
Here both packages search one state — the reference's engine carried over
with ``convert.engine_from_arrays`` — so the port must return the
reference's ids, and with them its recall, at int8 and at int4.
``pytest -s`` prints the recall of both.

Scale is cut (n = 8192, capacity 128) so the reference runs here; width,
data kind, pruner and k are the main path's.  Tolerances are those of
``test_torch_engine.py``.
"""
import numpy as np
import pytest

from repro.core.engine import SearchSpec as JSpec
from repro.core.engine import VectorSearchEngine as JEngine
from repro.core.pruners import random_orthogonal
from repro.data.synthetic import ground_truth, make_dataset, recall_at_k
from repro_torch.convert import engine_from_arrays
from repro_torch.core.engine import SearchSpec
from repro_torch.core.layout import device_mirror
from test_torch_engine import assert_same_results, ref_arrays

N, DIM, N_QUERIES, K = 8192, 960, 16, 10


@pytest.fixture(scope="module")
def wide():
    X, Q = make_dataset(N, DIM, "clustered", n_queries=N_QUERIES, seed=0)
    gt, _ = ground_truth(X, Q, k=K)
    je = JEngine.build(X, index="ivf", pruner="adsampling", capacity=128)
    return je, engine_from_arrays(ref_arrays(je), device="cpu"), Q, gt, X


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_fused_executors_match_reference_at_width_960(wide, dtype):
    je, te, Q, gt, _ = wide
    want = [je.search(q, JSpec(k=K, scan_dtype=dtype, kernel="jnp", executor="fused-scan"))
            for q in Q]
    got = [te.search(q, SearchSpec(k=K, scan_dtype=dtype, executor="fused-scan")) for q in Q]
    wb = je.search(Q, JSpec(k=K, scan_dtype=dtype, kernel="jnp", executor="fused-batch"))
    gb = te.search(Q, SearchSpec(k=K, scan_dtype=dtype, executor="fused-batch"))
    w_ids, g_ids = np.stack([r.ids for r in want]), np.stack([r.ids for r in got])
    assert_same_results(w_ids, np.stack([r.dists for r in want]),
                        g_ids, np.stack([r.dists for r in got]))
    assert_same_results(wb.ids, wb.dists, gb.ids, gb.dists)
    recalls = {"reference": (recall_at_k(w_ids, gt), recall_at_k(np.asarray(wb.ids), gt)),
               "port": (recall_at_k(g_ids, gt), recall_at_k(gb.ids, gt))}
    print(f"\n{dtype} recall@{K} (fused-scan, fused-batch) at n={N}, D={DIM}: {recalls}")
    assert recalls["port"] == recalls["reference"]
    if dtype == "int8":
        assert min(recalls["port"]) >= 0.95


def test_rotation_seeded_like_the_data_gathers_the_clusters_in_its_first_dims(wide):
    """``make_dataset`` and ``random_orthogonal`` both draw ``standard_normal``
    first from ``default_rng(seed)``: with one seed for both, the 64
    cluster centres share their draws with the rotation, and the clusters'
    spread lands in the first 64 rotated dimensions.  The int4 scale (max
    deviation / 7) there is then several times that of the rest, and its
    error decides the first d-tile's keep test.  An independent rotation
    spreads it evenly."""
    _, te, _, _, X = wide
    m = device_mirror(te.store, "int4")
    ratio = {0: float(m.scale[:64].mean() / m.scale[64:].mean())}
    Xt = X @ random_orthogonal(DIM, 1).T
    dev = np.abs(Xt - Xt.mean(0)).max(0)
    ratio[1] = float(dev[:64].mean() / dev[64:].mean())
    print(f"\nfirst-64 / other dims int4 scale, by rotation seed (data seed 0): {ratio}")
    assert ratio[0] > 4.0 and ratio[1] < 1.5
