"""The port's building blocks vs the reference's on the CPU: distances,
top-k and re-rank, pruners, PDXearch boundaries, k-means and IVF routing,
the copied synthetic data and the fused-scan work meter.

Host NumPy code (RNG draws, rotations, PCA, boundaries) must agree bit for
bit.  Float kernels are compared at rtol 1e-5 / atol 1e-4: both sides sum
f32 values of order 10^2 in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distance as jd
from repro.core import pruners as jp
from repro.core.pdxearch import make_boundaries as j_bounds
from repro.core.topk import TopK as JTopK
from repro.core.topk import rerank_positions as j_rerank
from repro.data import synthetic as jsyn
from repro.index import kmeans as jk
from repro.index.ivf import build_ivf as j_build_ivf
from repro.obs import meters as jmeters
from repro_torch.core import distance as td
from repro_torch.core import pruners as tp
from repro_torch.core.layout import build_flat_store, device_mirror
from repro_torch.core.pdxearch import make_boundaries as t_bounds
from repro_torch.core.topk import TopK, rerank_positions
from repro_torch.data import synthetic as tsyn
from repro_torch.index import kmeans as tk
from repro_torch.index.ivf import build_ivf as t_build_ivf
from repro_torch.obs import meters as tmeters
from repro_torch.obs import trace as ttrace

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
def test_distances_match_reference(metric):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((70, 33)).astype(np.float32)
    T = np.ascontiguousarray(X.T)
    q = rng.standard_normal(33).astype(np.float32)
    Q = rng.standard_normal((5, 33)).astype(np.float32)
    acc = rng.standard_normal(70).astype(np.float32)
    tX, tT, tq, tQ = map(torch.from_numpy, (X, T, q, Q))
    np.testing.assert_allclose(td.nary_distance(tX, tq, metric),
                               jd.nary_distance(X, q, metric), **TOL)
    np.testing.assert_allclose(td.pdx_distance(tT, tq, metric),
                               jd.pdx_distance(T, q, metric), **TOL)
    np.testing.assert_allclose(
        td.pdx_accumulate(tT[4:19], tq[4:19], torch.from_numpy(acc), metric),
        jd.pdx_accumulate(T[4:19], q[4:19], acc, metric), **TOL)
    np.testing.assert_allclose(td.batched_distance_matmul(tT, tQ, metric),
                               jd.batched_distance_matmul(T, Q, metric),
                               rtol=1e-4, atol=1e-3)


def test_rerank_positions_matches_reference():
    rng = np.random.default_rng(1)
    master = rng.standard_normal((3, 12, 40)).astype(np.float32)
    ids = rng.permutation(120).astype(np.int32).reshape(3, 40)
    ids[2, -5:] = -1
    Q = rng.standard_normal((4, 12)).astype(np.float32)
    pos = rng.integers(-1, 120, (4, 9)).astype(np.int32)
    d = rng.random((4, 9)).astype(np.float32)
    want = j_rerank(jnp.asarray(master), jnp.asarray(ids), jnp.asarray(Q),
                    JTopK(jnp.asarray(d), jnp.asarray(pos)), 5)
    got = rerank_positions(torch.from_numpy(master), torch.from_numpy(ids),
                           torch.from_numpy(Q),
                           TopK(torch.from_numpy(d), torch.from_numpy(pos)), 5)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **TOL)


@pytest.mark.parametrize("schedule", ["adaptive", "fixed"])
def test_boundaries_match_reference(schedule):
    for dim in (1, 7, 64, 960):
        assert t_bounds(dim, schedule, 24) == j_bounds(dim, schedule, 24)


def test_pruner_transforms_match_reference_bitwise():
    X, _ = jsyn.make_dataset(300, 20, "skewed", n_queries=1, seed=3)
    np.testing.assert_array_equal(tp.random_orthogonal(20, 5), jp.random_orthogonal(20, 5))
    for make_t, make_j in (
        (lambda: tp.make_adsampling(20, seed=5, device="cpu"), lambda: jp.make_adsampling(20, seed=5)),
        (lambda: tp.make_bsa(X, device="cpu"), lambda: jp.make_bsa(X)),
    ):
        t, j = make_t(), make_j()
        np.testing.assert_array_equal(t.preprocess(X), j.preprocess(X))
        assert t.fingerprint == j.fingerprint
        q = X[7]
        np.testing.assert_allclose(t.transform_query(torch.from_numpy(q)),
                                   j.transform_query(jnp.asarray(q)), **TOL)
        np.testing.assert_allclose(t.transform_batch(torch.from_numpy(X[:4])),
                                   np.stack([j.transform_query(jnp.asarray(r))
                                             for r in X[:4]]), **TOL)


@pytest.mark.parametrize("name", ["adsampling", "bsa", "bond"])
def test_keep_masks_match_reference(name):
    """The pruning predicates agree exactly, also at values on the bound."""
    X, _ = jsyn.make_dataset(300, 20, "normal", n_queries=1, seed=4)
    if name == "adsampling":
        t, j = tp.make_adsampling(20, eps0=2.1, device="cpu"), jp.make_adsampling(20, eps0=2.1)
    elif name == "bsa":
        t, j = tp.make_bsa(X, device="cpu"), jp.make_bsa(X)
    else:
        t, j = tp.make_bond(X.mean(0), device="cpu"), jp.make_bond(jnp.asarray(X.mean(0)))
    rng = np.random.default_rng(2)
    thr = np.float32(30.0)
    for d in (1, 2, 6, 14, 20):
        ratio, infl = tp.adsampling_bound_factors(20, 2.1, d)
        edge = np.float32(np.float32(thr * np.float32(infl)) / np.float32(ratio))
        partial = np.concatenate([
            rng.uniform(0, 80, 64).astype(np.float32),
            np.nextafter(edge, np.float32([0, np.inf])).astype(np.float32), [edge],
        ]).astype(np.float32)
        got = t.keep_mask(torch.from_numpy(partial), d, torch.tensor(thr))
        want = j.keep_mask(jnp.asarray(partial), jnp.float32(d), jnp.float32(thr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("zone_size", [0, 4])
def test_bond_dim_order_matches_reference(zone_size):
    X, Q = jsyn.make_dataset(200, 18, "skewed", n_queries=3, seed=6)
    t = tp.make_bond(X.mean(0), zone_size=zone_size, device="cpu")
    j = jp.make_bond(jnp.asarray(X.mean(0)), zone_size=zone_size)
    for q in Q:
        np.testing.assert_array_equal(t.dim_order(torch.from_numpy(q)).numpy(),
                                      np.asarray(j.dim_order(jnp.asarray(q))))


def test_synthetic_copy_is_identical():
    for kind in jsyn.DATASET_KINDS:
        a = tsyn.make_dataset(100, 9, kind, n_queries=3, seed=2)
        b = jsyn.make_dataset(100, 9, kind, n_queries=3, seed=2)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    X, Q = a
    for x, y in zip(tsyn.ground_truth(X, Q, 4), jsyn.ground_truth(X, Q, 4)):
        np.testing.assert_array_equal(x, y)


def test_kmeans_matches_reference():
    X, _ = jsyn.make_dataset(1200, 16, "clustered", n_queries=1, n_clusters=6, seed=1)
    tc, ta = tk.kmeans(torch.from_numpy(X), 6, iters=5, seed=3)
    jc, ja = jk.kmeans(X, 6, iters=5, seed=3)
    np.testing.assert_array_equal(ta, ja)  # well-separated: no near ties
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tk.assign(torch.from_numpy(X), torch.from_numpy(jc)).numpy(),
                                  np.asarray(jk.assign(X, jc)))


@pytest.mark.parametrize("route_dtype", ["f32", "int8", "int4"])
def test_ivf_routing_matches_reference(route_dtype):
    X, Q = jsyn.make_dataset(900, 12, "clustered", n_queries=4, seed=8)
    pre = jk.kmeans(X, 10, iters=5, seed=0)
    ji = j_build_ivf(X, 10, capacity=64, precomputed=pre)
    ti = t_build_ivf(X, 10, capacity=64, precomputed=pre, device="cpu")
    np.testing.assert_array_equal(ti.part_offsets, ji.part_offsets)
    for q in Q:
        tq = torch.from_numpy(q)
        np.testing.assert_array_equal(ti.rank_buckets(tq, "l2", route_dtype),
                                      ji.rank_buckets(jnp.asarray(q), "l2", route_dtype))
        to, ts = ti.route(tq, 3, "l2", route_dtype)
        jo, js = ji.route(jnp.asarray(q), 3, "l2", route_dtype)
        np.testing.assert_array_equal(to, jo)
        assert ts == js
    np.testing.assert_array_equal(ti.route_batch(torch.from_numpy(Q), 4),
                                  ji.route_batch(jnp.asarray(Q), 4))
    np.testing.assert_array_equal(ti.assign(X[:50]), ji.assign(X[:50]))


def test_ivf_tree_is_refused_until_ported():
    X, _ = jsyn.make_dataset(200, 8, "normal", n_queries=1, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_build_ivf(X, 4, capacity=64, tree=True, device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "int4"])
def test_fused_tile_counts_match_reference(dtype):
    X, Q = jsyn.make_dataset(700, 40, "normal", n_queries=1, seed=9)
    store = build_flat_store(X, capacity=128, device="cpu")
    m = device_mirror(store, dtype)
    thr = np.float32(np.sort(((X - Q[0]) ** 2).sum(1))[30])
    got = tmeters.fused_tile_counts(m.data, store.ids, torch.from_numpy(Q[0]), thr,
                                    m.scale, m.offset, eps0=2.1, d_tile=16,
                                    packed=m.packed, dim=m.dim)
    want = jmeters.fused_tile_counts(
        jnp.asarray(m.data.numpy()), jnp.asarray(store.ids.numpy()), Q[0], thr,
        jnp.asarray(m.scale.numpy()), jnp.asarray(m.offset.numpy()), eps0=2.1,
        d_tile=16, packed=m.packed, dim=m.dim)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tmeters.tile_widths(150, 64), jmeters.tile_widths(150, 64))


def test_fence_is_identity_off_the_card():
    x = (torch.ones(2), [torch.zeros(1)])
    assert ttrace.fence(x) is x


def test_search_records_spans_and_counters_when_enabled():
    """The copied registry and tracer are wired into the port's engine:
    plan/scan/rerank spans and the executor's counters, nothing when off."""
    from repro_torch.core.engine import SearchSpec, VectorSearchEngine
    from repro_torch.obs import metrics as tmetrics

    X, Q = jsyn.make_dataset(400, 16, "normal", n_queries=3, seed=1)
    eng = VectorSearchEngine.build(X, pruner="adsampling", capacity=128, device="cpu")
    reg = tmetrics.get_registry()
    reg.reset()
    assert eng.search(Q, SearchSpec(k=3, scan_dtype="int8")).trace is None
    tmetrics.set_enabled(True)
    try:
        res = eng.search(Q, SearchSpec(k=3, scan_dtype="int8"))
    finally:
        tmetrics.set_enabled(False)
    assert res.plan.executor == "fused-batch"
    assert {"plan", "scan", "rerank"} <= set(res.trace.span_names())
    snap = reg.snapshot()
    assert "repro_search_queries_total" in snap["counters"]
    assert "repro_device_bytes_total" in snap["counters"]
    reg.reset()
