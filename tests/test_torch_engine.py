"""repro_torch's engine vs the reference engine on the CPU, end to end.

Engines are built two ways: carried over from a reference engine's state
(``repro_torch.convert.engine_from_arrays``), and from the same rows X in
both packages with the reference's k-means result passed as
``precomputed_ivf`` (k-means sums round differently under ``segment_sum``
and ``index_add_``, so two independent k-means runs may cut other buckets).
Then adaptive, batch-matmul, fused-scan and fused-batch run on flat and IVF
engines at f32/bf16/int8/int4; the reference's fused executors run their
Pallas kernels in interpret mode.

Tolerances: ids equal, except a swap between neighbours whose reference
distances lie within 1e-5 relative of each other (sums taken in another
order can reorder such near-ties); distances allclose at rtol 1e-4 /
atol 1e-3 (the matmul form ||q||^2 - 2 q.x + ||x||^2 cancels to about
1e-7 of the norms).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.engine import SearchSpec as JSpec
from repro.core.engine import VectorSearchEngine as JEngine
from repro.core.pdxearch import SearchStats as JStats
from repro.core.pruners import pca_components, random_orthogonal
from repro.core.topk import TopK as JTopK
from repro.core.topk import topk_merge as j_merge
from repro.data.synthetic import ground_truth, make_dataset, recall_at_k
from repro.index.kmeans import kmeans as j_kmeans
from repro_torch.convert import engine_from_arrays
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.core.pdxearch import SearchStats
from repro_torch.core.topk import TopK, topk_merge

DTYPES = ("f32", "bf16", "int8", "int4")
EXECUTORS = ("adaptive", "batch-matmul", "fused-scan", "fused-batch")
# adaptive and batch-matmul scan the f32 masters whatever the scan dtype
CASES = [(ex, dt) for ex in EXECUTORS for dt in DTYPES
         if ex.startswith("fused") or dt == "f32"]


def ref_arrays(eng) -> dict:
    """A reference engine's state as NumPy arrays (the convert contract)."""
    s = eng.store
    out = {k: np.asarray(getattr(s, k))
           for k in ("data", "ids", "counts", "dim_means", "dim_vars")}
    pr = eng.pruner
    out["pruner"] = pr.name
    if pr.name == "adsampling":
        out["eps0"] = pr.aux["eps0"]
        out["rotation"] = random_orthogonal(pr.aux["dim"], pr.aux["seed"])
    if eng.ivf is not None:
        out.update(centroids=np.asarray(eng.ivf.centroids),
                   part_offsets=eng.ivf.part_offsets,
                   part_counts=eng.ivf.part_counts, nlist=eng.ivf.nlist)
    return out


def assert_same_results(want_ids, want_d, got_ids, got_d):
    want_ids, got_ids = np.atleast_2d(want_ids), np.atleast_2d(got_ids)
    want_d, got_d = np.atleast_2d(want_d), np.atleast_2d(got_d)
    for wi, wd, gi, gd in zip(want_ids, want_d, got_ids, got_d):
        for j in np.nonzero(wi != gi)[0]:
            # the port's id at j must be a reference neighbour (or the
            # reference's k-th) at a distance within 1e-5 of the one there
            near = np.abs(wd - wd[j]) <= 1e-5 * np.abs(wd[j])
            assert gi[j] in wi[near] or np.isclose(gd[j], wd[j], rtol=1e-5), (
                wi, gi, wd, gd)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def engines():
    """Reference and carried-over port engines: a flat store at 1900 x 50
    with PAD lanes, and an 8-bucket IVF store at 2048 x 32."""
    X, Q = make_dataset(1900, 50, "normal", n_queries=4, seed=7)
    flat = JEngine.build(X, pruner="adsampling", capacity=256)
    Xi, Qi = make_dataset(2048, 32, "clustered", n_queries=4, seed=4)
    ivf = JEngine.build(Xi, index="ivf", pruner="adsampling", capacity=128, nlist=8)
    return {
        "flat": (flat, engine_from_arrays(ref_arrays(flat), device="cpu"), Q),
        "ivf": (ivf, engine_from_arrays(ref_arrays(ivf), device="cpu"), Qi),
    }


@pytest.mark.parametrize("executor,dtype", CASES)
@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_executor_matches_reference(engines, kind, executor, dtype):
    je, te, Q = engines[kind]
    kernel = "pallas" if executor.startswith("fused") else "jnp"
    want = je.search(Q, JSpec(k=5, nprobe=3, scan_dtype=dtype, kernel=kernel,
                              executor=executor))
    got = te.search(Q, SearchSpec(k=5, nprobe=3, scan_dtype=dtype, executor=executor))
    assert got.plan.executor == want.plan.executor == executor
    assert_same_results(want.ids, want.dists, got.ids, got.dists)


def test_planner_on_cpu_keeps_plain_executors(engines):
    _, te, Q = engines["ivf"]
    assert te.plan(Q[0]).executor == "adaptive"
    assert te.plan(Q).executor == "adaptive"  # IVF batch: per-query routing
    _, tf, Qf = engines["flat"]
    assert tf.plan(Qf).executor == "batch-matmul"
    # a reduced-precision scan asks for the fused executors on any device
    assert tf.plan(Qf[0], SearchSpec(scan_dtype="int8")).executor == "fused-scan"
    assert tf.plan(Qf, SearchSpec(scan_dtype="int4")).executor == "fused-batch"
    p = tf.plan(Qf[0], SearchSpec(scan_dtype="bf16", metric="ip"))
    assert p.executor == "fused-batch"


@pytest.mark.parametrize("dtype", DTYPES)
def test_built_from_rows_with_precomputed_ivf(dtype):
    """Both packages build from the same rows and the same k-means result:
    stores equal bitwise, results equal the reference's."""
    X, Q = make_dataset(1500, 24, "clustered", n_queries=3, seed=11)
    Xt = X @ random_orthogonal(24, 0).T
    pre = j_kmeans(Xt, 6, iters=10, seed=0)
    kw = dict(index="ivf", pruner="adsampling", capacity=128, nlist=6,
              precomputed_ivf=pre)
    je = JEngine.build(X, **kw)
    te = VectorSearchEngine.build(X, device="cpu", **kw)
    for name in ("data", "ids", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(je.store, name)),
                                      getattr(te.store, name).numpy())
    for ex in (ex for ex, dt in CASES if dt == dtype):
        kernel = "pallas" if ex.startswith("fused") else "jnp"
        want = je.search(Q, JSpec(k=4, nprobe=2, scan_dtype=dtype, kernel=kernel,
                                  executor=ex))
        got = te.search(Q, SearchSpec(k=4, nprobe=2, scan_dtype=dtype, executor=ex))
        assert_same_results(want.ids, want.dists, got.ids, got.dists)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_fused_scan_stats_match_reference(engines, kind, dtype):
    je, te, Q = engines[kind]
    js, ts = JStats(), SearchStats()
    je.search(Q[0], JSpec(k=5, scan_dtype=dtype, kernel="pallas",
                          executor="fused-scan"), stats=js)
    te.search(Q[0], SearchSpec(k=5, scan_dtype=dtype, executor="fused-scan"),
              stats=ts)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.values_total > 0 and ts.partitions_visited == te.store.num_partitions


def test_adaptive_stats_match_reference(engines):
    je, te, Q = engines["flat"]
    js, ts = JStats(), SearchStats()
    je.search(Q[1], JSpec(k=5, executor="adaptive"), stats=js)
    te.search(Q[1], SearchSpec(k=5, executor="adaptive"), stats=ts)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


def test_topk_merge_breaks_ties_like_lax_top_k():
    """Equal values keep the lower index first, as ``jax.lax.top_k`` does —
    including the +inf ties of dead lanes and the -1 slots of the state."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        k = int(rng.integers(1, 9))
        sd = np.sort(rng.choice([0.5, 1.0, np.inf], size=k)).astype(np.float32)
        si = np.where(np.isinf(sd), -1, rng.integers(0, 50, k)).astype(np.int32)
        cd = rng.choice([0.5, 1.0, 2.0, np.inf], size=12).astype(np.float32)
        ci = rng.integers(-1, 50, 12).astype(np.int32)
        want = j_merge(JTopK(sd, si), cd, ci)
        got = topk_merge(TopK(torch.from_numpy(sd), torch.from_numpy(si)),
                         torch.from_numpy(cd), torch.from_numpy(ci))
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))


@pytest.mark.parametrize("executor", ["batch-matmul", "fused-batch", "fused-scan"])
def test_duplicate_rows_tie_like_reference(executor):
    """Eight copies of each row tie exactly; every executor must return the
    copies the reference returns (the lowest ids, in order)."""
    base, Q = make_dataset(40, 16, "normal", n_queries=2, seed=5)
    X = np.repeat(base, 8, axis=0)
    Q = base[[3, 17]]
    je = JEngine.build(X, pruner="linear", capacity=64)
    te = VectorSearchEngine.build(X, pruner="linear", capacity=64, device="cpu")
    kernel = "pallas" if executor.startswith("fused") else "jnp"
    want = je.search(Q, JSpec(k=6, kernel=kernel, executor=executor))
    got = te.search(Q, SearchSpec(k=6, executor=executor))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.ids[0], np.arange(24, 30))


def test_bsa_and_bond_pruners_carry_over():
    X, Q = make_dataset(800, 16, "skewed", n_queries=3, seed=2)
    for name in ("bsa", "bond"):
        je = JEngine.build(X, pruner=name, capacity=128)
        arrays = ref_arrays(je)
        if name == "bsa":
            comps, eig = pca_components(X)
            arrays.update(components=comps, eigval=eig, bsa_m=3.0)
        te = engine_from_arrays(arrays, device="cpu")
        want = je.search(Q, JSpec(k=5, executor="adaptive"))
        got = te.search(Q, SearchSpec(k=5, executor="adaptive"))
        assert_same_results(want.ids, want.dists, got.ids, got.dists)


def test_port_recall_on_clustered_ivf():
    """The port's own k-means + IVF build reaches exact recall through the
    fused executors' plain bodies at every dtype the reference holds to it."""
    X, Q = make_dataset(2048, 32, "clustered", n_queries=3, seed=4)
    gt, _ = ground_truth(X, Q, k=5)
    te = VectorSearchEngine.build(X, index="ivf", pruner="adsampling",
                                  capacity=128, nlist=8, device="cpu")
    for dtype in ("bf16", "int8"):
        res = te.search(Q, SearchSpec(k=5, scan_dtype=dtype))
        assert res.plan.executor == "fused-batch"
        assert recall_at_k(res.ids, gt) == 1.0
        r1 = te.search(Q[0], SearchSpec(k=5, scan_dtype=dtype))
        assert r1.plan.executor == "fused-scan"
        assert set(r1.ids.tolist()) == set(gt[0].tolist())
