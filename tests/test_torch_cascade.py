"""repro_torch's multi-resolution cascade vs the reference's, on the CPU.

The port runs its kernels' plain versions (``device="cpu"``) on state
carried over from a reference engine (``convert.engine_from_arrays``); the
reference runs its Pallas kernels in interpret mode (``kernel="pallas"``),
as ``tests/test_cascade.py`` does.  Covered: the projection mirror, the
planner's cascade dispatch, both cascade executors for the four ladders of
``tests/test_cascade.py`` on a flat store with PAD lanes and on an IVF store
at every routing dtype, ``cascade-batch`` == ``cascade-scan`` bitwise in
the port, and the hardware-independent work and byte models.

Tolerances: results as ``test_torch_engine.assert_same_results`` (ids
equal up to swaps of neighbours within 1e-5 relative, distances rtol 1e-4
/ atol 1e-3); projection components bitwise; projected tiles rtol 1e-5 /
atol 1e-4 at f32 (the einsum sums its products in another order), 1e-2
at bf16 (one rounding of those), within one quantization step at
int8/int4 (a level may round the other way at a step's midpoint); stats
and counters exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.engine import SearchSpec as JSpec
from repro.core.engine import VectorSearchEngine as JEngine
from repro.core.layout import projection_mirror as j_projection_mirror
from repro.core.pdxearch import SearchStats as JStats
from repro.data.synthetic import ground_truth, make_dataset, recall_at_k
from repro.obs import metrics as j_metrics
from repro_torch.convert import engine_from_arrays
from repro_torch.core.engine import SearchSpec
from repro_torch.core.layout import projection_mirror
from repro_torch.core.pdxearch import SearchStats
from repro_torch.kernels.ref import dequantize_ref
from repro_torch.obs import metrics as t_metrics
from test_torch_engine import assert_same_results, ref_arrays

LADDERS = [
    ("proj16:int8", "int4", "f32"),
    ("proj16:int4", "int8", "f32"),
    ("int8", "int4", "f32"),
    ("bf16", "int8", "f32"),
]
EXECUTORS = ("cascade-scan", "cascade-batch")


def _ids(c):
    return "→".join(c)


@pytest.fixture(scope="module")
def engines():
    """Reference engines and their carried-over port twins: the flat
    1900 x 50 store of ``tests/test_cascade.py`` (PAD lanes: 1900 % 256 !=
    0) and an 8-bucket IVF store at 2048 x 32."""
    X, Q = make_dataset(1900, 50, "clustered", n_queries=4, seed=7)
    flat = JEngine.build(X, pruner="adsampling", capacity=256)
    Xi, Qi = make_dataset(2048, 32, "clustered", n_queries=3, seed=4)
    ivf = JEngine.build(Xi, index="ivf", pruner="adsampling", capacity=128, nlist=8)
    return {
        "flat": (flat, engine_from_arrays(ref_arrays(flat), device="cpu"), X, Q),
        "ivf": (ivf, engine_from_arrays(ref_arrays(ivf), device="cpu"), Xi, Qi),
    }


def _search(je, te, Q, **kw):
    want = je.search(Q, JSpec(kernel="pallas", **kw))
    got = te.search(Q, SearchSpec(**kw))
    return want, got


# ------------------------------------------------------- projection mirror
@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "int4"])
def test_projection_mirror_matches_reference(engines, kind, dtype):
    je, te, _, _ = engines[kind]
    want = j_projection_mirror(je.store, 8, dtype)
    got = projection_mirror(te.store, 8, dtype)
    # the PCA sample is the first rows in id order, gathered without the
    # whole N-ary copy: the same values, so the same components bit for bit
    np.testing.assert_array_equal(got.components.numpy(), np.asarray(want.components))
    assert (got.rank, got.dim, got.packed, got.quantized) == (
        8, 8, dtype == "int4", dtype in ("int8", "int4"))
    assert got.data.shape == tuple(want.data.shape)
    live = te.store.ids.numpy() >= 0
    sc = got.scale if got.quantized else None
    off = got.offset if got.quantized else None
    mine = dequantize_ref(got.data, sc, off, dim_axis=1, packed=got.packed, dim=8).numpy()
    theirs = (np.asarray(want.data, np.float32) if not got.quantized else
              dequantize_ref(torch.from_numpy(np.array(want.data)),
                             torch.from_numpy(np.array(want.scale)),
                             torch.from_numpy(np.array(want.offset)),
                             dim_axis=1, packed=got.packed, dim=8).numpy())
    mine, theirs = (np.swapaxes(a, 1, 2)[live] for a in (mine, theirs))
    if got.quantized:
        # levels may round the other way at a step's midpoint: one step
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-5)
        np.testing.assert_allclose(got.offset.numpy(), np.asarray(want.offset),
                                   rtol=1e-5, atol=1e-5)
        assert np.all(np.abs(mine - theirs) <= got.scale.numpy() + 1e-4)
    else:
        tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bf16" else dict(rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(mine, theirs, **tol)


def test_projection_mirror_cache_and_lower_bound(engines):
    _, te, _, Q = engines["flat"]
    store = te.store
    m = projection_mirror(store, 8)
    assert m.rank == 8 and m.data.shape[1] == 8
    # cached per (rank, dtype, version); the PCA fit is shared across them
    assert projection_mirror(store, 8) is m
    m4 = projection_mirror(store, 8, "int4")
    assert m4 is not m and m4.packed and m4.data.shape[1] == 4
    assert torch.equal(m4.components, m.components)
    assert ("comps", 0) in store._proj_cache
    with pytest.raises(ValueError, match="rank"):
        projection_mirror(store, 64)
    with pytest.raises(ValueError, match="scan dtype"):
        projection_mirror(store, 8, "fp8")
    # orthonormal columns: the projected L2 lower-bounds the full L2 for
    # every query/vector pair, which the cascade's first keep test rests on
    C = m.components.numpy()
    np.testing.assert_allclose(C.T @ C, np.eye(8), atol=1e-4)
    live = store.ids.numpy() >= 0
    P = np.swapaxes(m.data.numpy(), 1, 2)[live]        # (n, rank)
    T = np.swapaxes(store.data.numpy(), 1, 2)[live]    # (n, D)
    for q in Q @ te.pruner.aux["rotation"].T:
        d_proj = ((P - q @ C) ** 2).sum(axis=1)
        d_full = ((T - q) ** 2).sum(axis=1)
        assert np.all(d_proj <= d_full + 1e-2)


# ---------------------------------------------------------------- planner
def test_planner_dispatches_the_cascade(engines):
    je, te, _, Q = engines["flat"]
    spec = SearchSpec(k=5, cascade=("proj8:int8", "int4", "f32"))
    one, many = te.plan(Q[0], spec), te.plan(Q, spec)
    assert (one.executor, many.executor) == ("cascade-scan", "cascade-batch")
    for p in (one, many):
        assert "proj8:int8" in p.reason and "cascade" in p.reason
    jspec = JSpec(k=5, cascade=spec.cascade, kernel="pallas")
    assert je.plan(Q[0], jspec).executor == one.executor
    assert je.plan(Q, jspec).executor == many.executor
    # the cascade comes before the fused executors, whatever the scan dtype
    assert te.plan(Q, spec.replace(scan_dtype="int8")).executor == "cascade-batch"
    # a forced non-cascade executor runs, and says it ignored the cascade
    p = te.plan(Q, spec.replace(executor="fused-batch"))
    assert p.executor == "fused-batch" and "cascade ignored" in p.reason
    # no cascade: the single-level dispatch is untouched
    assert te.plan(Q[0], SearchSpec(k=5)).executor == "adaptive"
    with pytest.raises(ValueError, match="needs spec.cascade"):
        te.search(Q, SearchSpec(k=5, executor="cascade-batch"))


# ----------------------------------------------------- executor parity
@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("cascade", LADDERS, ids=_ids)
def test_cascade_matches_reference_on_flat_store(engines, cascade, executor):
    je, te, X, Q = engines["flat"]
    want, got = _search(je, te, Q, k=5, cascade=cascade, executor=executor)
    assert got.plan.executor == want.plan.executor == executor
    assert_same_results(want.ids, want.dists, got.ids, got.dists)
    gt, _ = ground_truth(X, Q, k=5)
    assert recall_at_k(got.ids, gt) == 1.0


@pytest.mark.parametrize("route_dtype", ["f32", "int8", "int4"])
def test_cascade_matches_reference_on_ivf_store(engines, route_dtype):
    je, te, X, Q = engines["ivf"]
    for executor in EXECUTORS:
        want, got = _search(je, te, Q, k=5, cascade=("proj8:int8", "int4", "f32"),
                            route_dtype=route_dtype, executor=executor)
        assert got.plan.executor == executor
        assert_same_results(want.ids, want.dists, got.ids, got.dists)
        r1 = te.search(Q[1], SearchSpec(k=5, cascade=("int8", "f32"),
                                        route_dtype=route_dtype))
        w1 = je.search(Q[1], JSpec(k=5, cascade=("int8", "f32"), kernel="pallas",
                                   route_dtype=route_dtype))
        assert r1.plan.executor == "cascade-scan"
        assert_same_results(w1.ids, w1.dists, r1.ids, r1.dists)
    gt, _ = ground_truth(X, Q, k=5)
    assert recall_at_k(got.ids, gt) == 1.0


@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("cascade", LADDERS, ids=_ids)
def test_cascade_batch_equals_cascade_scan_bitwise(engines, kind, cascade):
    """The batched executor restructures the stage ladder (shared bitmap,
    compacted gather, K2 per d-tile), never the survivor set or the exact
    re-rank: ids and distances equal the per-query executor's bit for bit."""
    _, te, _, Q = engines[kind]
    b = te.search(Q, SearchSpec(k=5, cascade=cascade))
    s = te.search(Q, SearchSpec(k=5, cascade=cascade, executor="cascade-scan"))
    assert (b.plan.executor, s.plan.executor) == ("cascade-batch", "cascade-scan")
    np.testing.assert_array_equal(b.ids, s.ids)
    np.testing.assert_array_equal(b.dists, s.dists)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_rerank_span_holds_the_rerank(engines, executor):
    """The exact f32 re-rank runs outside the kernels: its span wraps the
    work (one per query in cascade-scan, one per batch in cascade-batch)
    and names the widened re-rank width."""
    _, te, _, Q = engines["flat"]
    spec = SearchSpec(k=5, cascade=("proj16:int8", "int4", "f32"), executor=executor)
    t_metrics.set_enabled(True)
    try:
        res = te.search(Q, spec)
    finally:
        t_metrics.set_enabled(False)
        t_metrics.get_registry().reset()
    spans = [s for s in res.trace.spans if s.name == "rerank"]
    assert len(spans) == (len(Q) if executor == "cascade-scan" else 1)
    for s in spans:
        assert s.t1 > s.t0 and "fused" not in s.attrs
        assert s.attrs["rk"] >= spec.rerank_mult * spec.k


# ------------------------------------------------ work and byte models
@pytest.fixture
def both_registries():
    regs = (j_metrics.get_registry(), t_metrics.get_registry())
    for mod, reg in zip((j_metrics, t_metrics), regs):
        reg.reset()
        mod.set_enabled(True)
    try:
        yield regs
    finally:
        for mod, reg in zip((j_metrics, t_metrics), regs):
            mod.set_enabled(False)
            reg.reset()


def _cascade_counters(reg) -> dict:
    snap = reg.snapshot()["counters"]
    out = {k: v for k, v in snap.items() if k.startswith("repro_cascade_stage")}
    out["device_bytes"] = {
        lbl: v for lbl, v in snap.get("repro_device_bytes_total", {}).items()
        if "cascade-" in lbl
    }
    return out


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("kind,cascade", [
    ("flat", ("proj16:int8", "int4", "f32")),
    ("flat", ("bf16", "int8", "f32")),
    ("ivf", ("proj8:int4", "int8", "f32")),
], ids=lambda v: v if isinstance(v, str) else _ids(v))
def test_stats_and_counters_equal_the_reference(engines, both_registries, kind,
                                                cascade, executor):
    je, te, _, Q = engines[kind]
    js, ts = JStats(), SearchStats()
    je.search(Q, JSpec(k=5, cascade=cascade, kernel="pallas", executor=executor), stats=js)
    te.search(Q, SearchSpec(k=5, cascade=cascade, executor=executor), stats=ts)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert 0 < ts.values_computed and ts.partitions_visited == te.store.num_partitions * len(Q)
    jreg, treg = both_registries
    want, got = _cascade_counters(jreg), _cascade_counters(treg)
    assert got == want
    assert got["repro_cascade_stage_survivors"] and got["device_bytes"]
