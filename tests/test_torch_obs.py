"""repro_torch's engine telemetry against the reference's, on the CPU.

Mirrors the single-device tests of ``tests/test_obs.py``
(``test_engine_metrics_trace_and_stats_parity``,
``test_stats_populated_on_every_single_device_executor``, the two cascade
meter tests and ``test_cache_and_mutation_metrics``) on the port, and holds
what hardware does not change to the reference exactly: ``SearchStats``,
the mutation meters, the cascade counters and ``fused_demand_bytes``.
Port engines that must match a reference engine are carried over from it
(``convert.engine_from_arrays``), so both scan one store.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import SearchSpec as JSpec
from repro.core.engine import VectorSearchEngine as JEngine
from repro.core.layout import device_mirror as j_device_mirror
from repro.core.pdxearch import SearchStats as JStats
from repro.core.topk import topk_from_batch as j_topk_from_batch
from repro.data.synthetic import make_dataset
from repro.obs import meters as jmeters
from repro.obs import metrics as j_metrics
from repro_torch.convert import engine_from_arrays
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.core.layout import device_mirror
from repro_torch.core.pdxearch import SearchStats
from repro_torch.core.plan import pow2_bucket
from repro_torch.core.topk import topk_from_batch, topk_threshold
from repro_torch.obs import meters as tmeters
from repro_torch.obs import metrics, trace

from test_torch_engine import ref_arrays

CPU = dict(device="cpu")


@pytest.fixture
def obs():
    """Enable the port's telemetry on a clean registry/ring; always restore
    disabled."""
    reg = metrics.get_registry()
    tr = trace.get_tracer()
    reg.reset()
    tr.clear()
    metrics.set_enabled(True)
    try:
        yield reg
    finally:
        metrics.set_enabled(False)
        reg.reset()
        tr.clear()


@pytest.fixture
def both_registries(obs):
    jreg = j_metrics.get_registry()
    jreg.reset()
    j_metrics.set_enabled(True)
    try:
        yield jreg, obs
    finally:
        j_metrics.set_enabled(False)
        jreg.reset()


@pytest.fixture(scope="module")
def ivf_pair():
    """The reference's IVF + ADSampling engine at 2048 x 32, nlist 16, and
    the port's carried over from it."""
    X, Q = make_dataset(2048, 32, "clustered", n_queries=4, seed=2)
    je = JEngine.build(X, index="ivf", pruner="adsampling", capacity=128,
                       nlist=16)
    return je, engine_from_arrays(ref_arrays(je), **CPU), X, Q


# ------------------------------------------------------------ engine telemetry
def test_engine_metrics_trace_and_stats_parity(obs, ivf_pair, tmp_path):
    je, eng, _, Q = ivf_pair
    stats = SearchStats()
    res = eng.search(Q[0], SearchSpec(k=5), stats=stats)
    assert res.plan.executor == "adaptive"
    qt = res.trace
    assert qt is not None and qt.attrs["executor"] == "adaptive"
    names = qt.span_names()
    assert names.index("plan") < names.index("route") < names.index("scan")
    assert "merge" in names
    assert qt.duration_s > 0 and all(s.duration_s >= 0 for s in qt.spans)

    snap = eng.metrics()
    assert snap["counters"]["repro_search_batches_total"]["executor=adaptive"] \
        == 1.0
    assert snap["counters"]["repro_search_queries_total"]["executor=adaptive"] \
        == 1.0
    # the registry mirrors the SearchStats work account exactly
    for kind, want in (
        ("total", stats.values_total),
        ("computed", stats.values_computed),
        ("avoided", stats.values_avoided),
    ):
        got = obs.get(
            "repro_pruning_values_total", executor="adaptive", kind=kind,
        )
        assert got == pytest.approx(want), (kind, got, want)
    hist = snap["histograms"]["repro_search_latency_seconds"]
    assert hist["executor=adaptive"]["count"] == 1
    # ... and the account is the reference's on the same store
    js = JStats()
    je.search(Q[0], JSpec(k=5), stats=js)
    assert dataclasses.asdict(stats) == dataclasses.asdict(js)

    # Perfetto export round-trips through engine.dump_trace
    path = tmp_path / "trace.json"
    doc = eng.dump_trace(str(path))
    names = [e["name"] for e in doc["traceEvents"]]
    assert "query" in names and "scan" in names and "merge" in names
    assert json.loads(path.read_text()) == doc


def test_engine_members_match_reference(ivf_pair):
    je, eng, _, _ = ivf_pair
    assert (eng.metric, eng.num_vectors, eng.dim) == (
        je.metric, je.num_vectors, je.dim)
    assert eng.head_capacity == je.head_capacity == 256
    assert isinstance(eng.metrics(), dict) and "counters" in eng.metrics()


def test_stats_populated_on_every_single_device_executor(obs, ivf_pair):
    _, eng, X, Q = ivf_pair
    total_1 = float(eng.store.counts.sum()) * eng.store.dim
    # exact=True: the executor scans the whole store at full width, so the
    # work account must be saturated (computed == total == live * D * B);
    # exact=False paths account only what they visit/compute
    flat = VectorSearchEngine.build(X, pruner="adsampling", capacity=128, **CPU)
    cases = [
        (eng, "adaptive", SearchSpec(k=5), Q[0], False),
        (flat, "batch-matmul", SearchSpec(k=5), Q, True),
        (eng, "fused-scan", SearchSpec(k=5, scan_dtype="int8",
                                       executor="fused-scan"), Q[0], False),
        (eng, "fused-batch", SearchSpec(k=5, scan_dtype="bf16",
                                        executor="fused-batch"), Q, True),
    ]
    for e, name, spec, q, exact in cases:
        stats = SearchStats()
        res = e.search(q, spec, stats=stats)
        assert res.plan.executor == name, res.plan
        B = 1 if q.ndim == 1 else len(q)
        assert 0 < stats.values_total <= total_1 * B + 1e-6, name
        assert 0 < stats.values_computed <= stats.values_total, name
        if exact:
            assert stats.values_total == pytest.approx(total_1 * B), name
            assert stats.values_computed == stats.values_total, name
        assert stats.values_avoided == pytest.approx(
            stats.values_total - stats.values_computed
        ), name
        assert stats.partitions_visited > 0, name
    # jit-masked (flat store) obeys the same identity
    stats = SearchStats()
    res = flat.search(Q[0], SearchSpec(k=5, prefer_static=True), stats=stats)
    assert res.plan.executor == "jit-masked", res.plan
    assert stats.values_total > 0
    assert stats.values_avoided == pytest.approx(
        stats.values_total - stats.values_computed
    )


@pytest.fixture(scope="module")
def flat_normal():
    X, Q = make_dataset(2048, 32, "normal", n_queries=4, seed=6)
    je = JEngine.build(X, pruner="adsampling", capacity=128)
    return je, engine_from_arrays(ref_arrays(je), **CPU), Q


def _cascade_counters(reg) -> dict:
    snap = reg.snapshot()["counters"]
    out = {k: v for k, v in snap.items() if k.startswith("repro_cascade_stage")}
    out["device_bytes"] = {
        lbl: v for lbl, v in snap.get("repro_device_bytes_total", {}).items()
        if "cascade-" in lbl
    }
    return out


def test_cascade_stage_meters(both_registries, flat_normal):
    """The cascade executor reports per-stage survivors and realized bytes:
    survivors are monotone non-increasing across stages, never drop below
    k on an exact-recall config, and the byte meters reflect each stage
    mirror's width; every counter equals the reference's."""
    jreg, reg = both_registries
    je, eng, Q = flat_normal
    cascade = ("proj8:int8", "int4", "f32")
    stats = SearchStats()
    res = eng.search(
        Q, SearchSpec(k=5, cascade=cascade, executor="cascade-scan"),
        stats=stats,
    )
    assert res.plan.executor == "cascade-scan", res.plan
    surv = [
        reg.get("repro_cascade_stage_survivors", stage=str(si),
                stage_name=cascade[si])
        for si in range(2)
    ]
    byts = [
        reg.get("repro_cascade_stage_bytes", stage=str(si),
                stage_name=cascade[si])
        for si in range(2)
    ]
    assert surv[0] >= surv[1] >= len(Q) * 5  # monotone, >= k per query
    P, C, D = (eng.store.num_partitions, eng.store.capacity, eng.store.dim)
    assert byts[0] == pytest.approx(len(Q) * P * 8 * C * 1)
    assert 0 < byts[1] <= len(Q) * P * D * C * 0.5
    pmodel = [
        reg.get("repro_cascade_stage_bytes_partition_model", stage=str(si),
                stage_name=cascade[si])
        for si in range(2)
    ]
    assert byts[0] == pytest.approx(pmodel[0])
    assert 0 < byts[1] <= pmodel[1]
    assert reg.get("repro_device_bytes_total", executor="cascade-scan",
                   component="scan", dtype="int8") == byts[0]
    assert reg.get("repro_device_bytes_total", executor="cascade-scan",
                   component="scan", dtype="int4") == byts[1]
    assert reg.get("repro_device_bytes_total", executor="cascade-scan",
                   component="start", dtype="f32") > 0
    assert reg.get("repro_device_bytes_total", executor="cascade-scan",
                   component="rerank", dtype="f32") > 0
    total_1 = float(eng.store.counts.sum()) * eng.store.dim
    assert stats.values_computed > 0
    assert stats.values_total == pytest.approx(total_1 * len(Q))
    assert stats.values_avoided == max(
        stats.values_total - stats.values_computed, 0.0
    )
    js = JStats()
    je.search(Q, JSpec(k=5, cascade=cascade, kernel="jnp",
                       executor="cascade-scan"), stats=js)
    assert dataclasses.asdict(stats) == dataclasses.asdict(js)
    assert _cascade_counters(reg) == _cascade_counters(jreg)


def test_cascade_batch_meters_amortize_bytes(both_registries, flat_normal):
    """The batched cascade pays each stage's compacted-union gather ONCE
    per batch: stage-0 bytes equal the pow2-padded union width exactly."""
    jreg, reg = both_registries
    je, eng, Q = flat_normal
    cascade = ("proj8:int8", "int4", "f32")
    res = eng.search(Q, SearchSpec(k=5, cascade=cascade))
    assert res.plan.executor == "cascade-batch", res.plan
    P, C = eng.store.num_partitions, eng.store.capacity
    b0 = reg.get("repro_cascade_stage_bytes", stage="0",
                 stage_name=cascade[0])
    assert b0 == pytest.approx(pow2_bucket(P * C, P * C) * 8 * 1)
    assert b0 <= len(Q) * P * 8 * C  # never worse than B per-query walks
    assert reg.get("repro_device_bytes_total", executor="cascade-batch",
                   component="scan", dtype="int8") == b0
    assert reg.get("repro_device_bytes_total", executor="cascade-batch",
                   component="rerank", dtype="f32") > 0
    je.search(Q, JSpec(k=5, cascade=cascade, kernel="jnp"))
    assert _cascade_counters(reg) == _cascade_counters(jreg)


def _store_meters(reg) -> dict:
    snap = reg.snapshot()
    return {kind: {k: v for k, v in snap[kind].items()
                   if k.startswith(("repro_store_", "repro_mirror_builds"))}
            for kind in ("counters", "gauges")}


def test_cache_and_mutation_metrics(both_registries):
    jreg, reg = both_registries
    X, _ = make_dataset(1024, 16, "normal", n_queries=1, seed=3)
    eng = VectorSearchEngine.build(X, pruner="linear", capacity=128, **CPU)
    jeng = JEngine.build(X, pruner="linear", capacity=128)
    for e in (eng, jeng):
        e.insert(X[:8] + 0.5)
    assert reg.get("repro_store_mutations_total", op="insert") == 1.0
    assert reg.get("repro_store_rows_mutated_total", op="insert") == 8.0
    assert reg.get("repro_store_live_vectors") == 1032.0
    assert 0.0 < reg.get("repro_store_head_fill") <= 1.0
    for e in (eng, jeng):
        e.delete(np.arange(4))
    assert reg.get("repro_store_mutations_total", op="delete") == 1.0
    assert reg.get("repro_store_live_vectors") == 1028.0
    # a search uploads once per tiles_version, a compact repacks
    for e in (eng, jeng):
        e.search(X[:3], k=3, scan_dtype="int8")
        e.search(X[:3], k=3, scan_dtype="int8")
        e.compact()
        e.search(X[0], k=3)
    assert reg.get("repro_store_device_uploads_total") == 2.0
    assert reg.get("repro_store_mutations_total", op="repack") == 1.0
    assert _store_meters(reg) == _store_meters(jreg)


@pytest.mark.parametrize("dtype", ["f32", "int8", "int4"])
def test_fused_demand_bytes_matches_reference(ivf_pair, dtype):
    je, eng, _, Q = ivf_pair
    qt = eng.pruner.transform_query(torch.from_numpy(Q[1]))
    jq = jnp.asarray(qt.numpy())
    order, _ = eng.ivf.route(qt, 1, "l2")
    p0 = int(order[0])
    thr = topk_threshold(topk_from_batch(
        ((eng.store.data[p0] - qt[:, None]) ** 2).sum(0), eng.store.ids[p0], 5))
    jstart = j_topk_from_batch(
        ((je.store.data[p0] - jq[:, None]) ** 2).sum(0), je.store.ids[p0], 5)
    got = tmeters.fused_demand_bytes(
        device_mirror(eng.store, dtype), eng.store.ids, qt, thr, p0=p0,
        eps0=2.1)
    want = jmeters.fused_demand_bytes(
        j_device_mirror(je.store, dtype), je.store.ids, jq,
        float(thr), p0=p0, eps0=2.1)
    assert got == want
    assert float(jstart.dists[-1]) == pytest.approx(float(thr), rel=1e-5)
    C, D = eng.store.capacity, eng.store.dim
    assert D * C * 4 < got <= D * C * 4 + eng.store.num_partitions * D * C * 4
