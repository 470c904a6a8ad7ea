"""repro_torch's vector-serving tier against the reference's, on the CPU.

Mirrors the vector-serving tests of ``tests/test_serve.py`` (the batcher
primitives and ``VectorServer``) and
``tests/test_tiered.py::test_server_delta_replay_under_continuous_inserts``
on the port, with ``kernel="torch"`` where the reference says
``kernel="jnp"`` and the executors forced on the CPU as they are there.
Then parity on identical state (engines carried over from a reference
engine through ``convert.engine_from_arrays``, the rotation included): a
reference server and the port's serve the same queries with the same ids;
``prepare_execute(...).run()`` equals ``execute`` for every ported
executor and the reference's ``prepare_execute``; a tiered ``prepare`` of
batch N+1 that evicts batch N's buckets before ``run(N)`` leaves N its
blocking ids; ``warm_shapes`` returns the reference's ``{bucket:
executor}``.  And the set-up counter (``obs.setups``): a fresh engine's
first search moves it, and after ``warmup()`` a plain, a cascade and a
tiered spec move it no more.

Tolerances: ids and distances between two runs of the port equal exactly
(the same arithmetic on the same state); port against reference as
``test_torch_engine.assert_same_results`` (ids equal up to swaps of
neighbours within 1e-5 relative, distances rtol 1e-4 / atol 1e-3).  Each
future is waited for at most 30 s, as the reference's tests wait.
"""
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core.engine import SearchSpec as JSpec
from repro.core.engine import VectorSearchEngine as JEngine
from repro.serve.vector import VectorServer as JServer
from repro_torch.convert import engine_from_arrays
from repro_torch.core import plan as tplan
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.core.layout import MutablePDXStore, build_flat_store
from repro_torch.obs import setups
from repro_torch.serve import jit_compile_count
from repro_torch.serve.batcher import (
    AdmissionQueue,
    DeadlineExceeded,
    QueryItem,
    ServerClosed,
    ServerOverloaded,
    pad_batch,
    shape_bucket,
)
from repro_torch.serve.vector import VectorServer

from test_torch_engine import assert_same_results, ref_arrays

CPU = dict(device="cpu")


def _item(spec="s", deadline=None, q=None):
    return QueryItem(
        query=q if q is not None else np.zeros(4, np.float32),
        spec=spec,
        future=Future(),
        t_enqueue=time.perf_counter(),
        deadline=deadline,
    )


def _vec_engine(n=1024, dim=32, seed=0, **kw):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    eng = VectorSearchEngine.build(
        X, pruner=kw.pop("pruner", "adsampling"),
        capacity=kw.pop("capacity", 256), **CPU, **kw,
    )
    return eng, X


# ------------------------------------------------- batcher primitives
def test_shape_bucket_pow2():
    assert [shape_bucket(n, 64) for n in (1, 2, 3, 5, 8, 9, 64)] == [
        1, 2, 4, 8, 8, 16, 64
    ]
    assert shape_bucket(100, 64) == 64
    with pytest.raises(ValueError):
        shape_bucket(0, 64)


def test_pad_batch_repeats_last_row():
    Q = np.arange(12, dtype=np.float32).reshape(3, 4)
    P = pad_batch(Q, 8)
    assert P.shape == (8, 4)
    np.testing.assert_array_equal(P[3:], np.repeat(Q[-1:], 5, axis=0))
    assert pad_batch(Q, 3) is Q
    with pytest.raises(ValueError):
        pad_batch(Q, 2)


def test_admission_queue_empty_flush_times_out():
    q = AdmissionQueue(8)
    t0 = time.perf_counter()
    batch, expired = q.drain(4, window_s=0.0, timeout_s=0.02)
    assert batch == [] and expired == []
    assert time.perf_counter() - t0 < 1.0


def test_admission_queue_deadline_expiry_mid_queue():
    q = AdmissionQueue(8)
    live = _item()
    dead = _item(deadline=time.perf_counter() - 1.0)
    live2 = _item()
    for it in (live, dead, live2):
        assert q.put(it)
    batch, expired = q.drain(4, timeout_s=0.1)
    assert batch == [live, live2]
    assert expired == [dead]
    assert len(q) == 0


def test_admission_queue_groups_by_spec_preserving_order():
    q = AdmissionQueue(8)
    a1, b1, a2 = _item("a"), _item("b"), _item("a")
    for it in (a1, b1, a2):
        q.put(it)
    batch, _ = q.drain(4, timeout_s=0.1)
    assert batch == [a1, a2]          # same-spec coalesced
    batch2, _ = q.drain(4, timeout_s=0.1)
    assert batch2 == [b1]             # different spec waited its turn


def test_admission_queue_backpressure_and_close():
    q = AdmissionQueue(2)
    assert q.put(_item()) and q.put(_item())
    assert not q.put(_item())          # full -> reject, never block
    q.close()
    with pytest.raises(ServerClosed):
        q.put(_item())
    # closed but non-empty: drain still returns the queued work
    batch, _ = q.drain(4, timeout_s=0.1)
    assert len(batch) == 2
    assert q.drain(4, timeout_s=0.1) == ([], [])


# ------------------------------------------------------ VectorServer
def test_server_single_query_smallest_bucket_no_recompile():
    eng, X = _vec_engine()
    spec = eng.spec.replace(k=5, executor="batch-matmul")
    with VectorServer(eng, spec=spec, max_batch=8) as srv:
        srv.warmup()
        ids, dists = srv.search(X[3])
        assert ids.shape == (5,) and ids[0] == 3
        assert srv.jit_compiles_since_warmup() == 0


def test_server_cascade_warmup_zero_recompiles():
    """warmup() with a cascade spec builds every stage mirror, so a served
    cascade workload whose survivor counts differ from the warm batch's
    still builds nothing (the port keeps no state per compaction width)."""
    eng, X = _vec_engine(n=1024, dim=32)
    spec = eng.spec.replace(
        k=5, cascade=("int8", "f32"), kernel="torch",
    )
    with VectorServer(eng, spec=spec, max_batch=8) as srv:
        srv.warmup()
        futs = [srv.submit(X[i]) for i in range(16)]
        for i, f in enumerate(futs):
            ids, _ = f.result(timeout=30)
            assert ids[0] == i
        assert srv.jit_compiles_since_warmup() == 0


def test_server_matches_engine_results():
    eng, X = _vec_engine()
    spec = eng.spec.replace(k=10, executor="batch-matmul")
    ref = eng.search(X[:6], spec)
    with VectorServer(eng, spec=spec, max_batch=8) as srv:
        futs = [srv.submit(X[i]) for i in range(6)]
        for i, f in enumerate(futs):
            ids, dists = f.result(timeout=30)
            np.testing.assert_array_equal(ids, np.asarray(ref.ids)[i])


def test_server_shutdown_drains_in_flight():
    eng, X = _vec_engine()
    spec = eng.spec.replace(k=5, executor="batch-matmul")
    srv = VectorServer(eng, spec=spec, max_batch=4, flush_interval_s=0.0)
    futs = [srv.submit(X[i]) for i in range(12)]
    srv.close(drain=True)
    for i, f in enumerate(futs):
        ids, _ = f.result(timeout=1)   # already done: drain completed them
        assert ids[0] == i
    with pytest.raises(ServerClosed):
        srv.submit(X[0])


def test_server_close_without_drain_fails_queued():
    eng, X = _vec_engine()
    spec = eng.spec.replace(k=5, executor="batch-matmul")
    srv = VectorServer(eng, spec=spec, max_batch=4)
    futs = [srv.submit(X[i]) for i in range(8)]
    srv.close(drain=False)
    outcomes = set()
    for f in futs:
        try:
            f.result(timeout=1)
            outcomes.add("ok")
        except ServerClosed:
            outcomes.add("closed")
    assert "closed" in outcomes        # at least the still-queued ones failed


def test_server_deadline_exceeded():
    eng, X = _vec_engine()
    spec = eng.spec.replace(k=5, executor="batch-matmul")
    with VectorServer(eng, spec=spec, max_batch=4) as srv:
        fut = srv.submit(X[0], timeout_s=-0.001)   # already expired
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)


def test_server_overload_rejects():
    eng, X = _vec_engine()
    spec = eng.spec.replace(k=5, executor="batch-matmul")
    srv = VectorServer(eng, spec=spec, max_batch=1, queue_depth=1,
                       flush_interval_s=0.0)
    # stall the executor stage so submissions pile up in the bounded queue
    rejected = 0
    try:
        for i in range(200):
            try:
                srv.submit(X[i % len(X)])
            except ServerOverloaded:
                rejected += 1
                break
        assert rejected >= 1
    finally:
        srv.close(drain=True)


def test_server_mutations_and_version_fenced_maintenance():
    eng, X = _vec_engine()
    spec = eng.spec.replace(k=5, executor="batch-matmul")
    with VectorServer(eng, spec=spec, max_batch=8,
                      maintenance_interval_s=0.02,
                      head_fill_threshold=0.0) as srv:
        rng = np.random.default_rng(1)
        V = rng.standard_normal((4, X.shape[1])).astype(np.float32)
        new_ids = srv.insert(V).result(timeout=30)
        assert len(new_ids) == 4
        # a freshly inserted vector is immediately searchable via the server
        ids, _ = srv.search(V[2])
        assert ids[0] == new_ids[2]
        assert srv.delete([int(new_ids[0])]).result(timeout=30) == 1
        deadline = time.time() + 10
        while time.time() < deadline:
            if getattr(eng.store, "head_count", 1) == 0:
                break                   # background repack drained the head
            time.sleep(0.02)
        assert eng.store.head_count == 0
        ids, _ = srv.search(V[2])       # survives the adopted repack
        assert ids[0] == new_ids[2]


def test_store_adopt_version_fence():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((100, 8)).astype(np.float32)
    ms = MutablePDXStore.from_store(build_flat_store(X, capacity=32, **CPU),
                                    head_capacity=16)
    ms.insert(rng.standard_normal((2, 8)).astype(np.float32))
    base = ms.version
    clone = ms.clone()
    clone.repack()
    # a mutation lands between clone and adopt -> the swap must be refused
    ms.insert(rng.standard_normal((1, 8)).astype(np.float32))
    assert not ms.adopt(clone, expect_version=base)
    assert ms.num_vectors == 103
    # retry against the now-current version succeeds
    base2 = ms.version
    clone2 = ms.clone()
    clone2.repack()
    assert ms.adopt(clone2, expect_version=base2)
    assert ms.num_vectors == 103 and ms.head_count == 0


def test_server_delta_replay_under_continuous_inserts():
    """Background repacks under a steady insert stream must keep adopting
    (delta replay) — every inserted id stays searchable afterwards."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((256, 16)).astype(np.float32)
    eng = VectorSearchEngine.build(X, index="flat", pruner="linear",
                                   capacity=64, **CPU)
    spec = eng.spec.replace(k=4, executor="batch-matmul")
    with VectorServer(eng, spec=spec, max_batch=8,
                      maintenance_interval_s=0.01,
                      head_fill_threshold=0.0) as srv:
        all_ids = []
        for _ in range(12):
            V = rng.standard_normal((4, 16)).astype(np.float32)
            all_ids.append((srv.insert(V).result(timeout=30), V))
        deadline = time.time() + 15
        while time.time() < deadline and eng.store.head_count:
            time.sleep(0.02)
        for ids, V in all_ids:
            got, _ = srv.search(V[0])
            assert got[0] == ids[0]
    assert eng.store.num_vectors == 256 + 48


# --------------------------------------------------- port-only contracts
def test_server_serves_a_cpu_engine_with_the_reference_call_shape(monkeypatch):
    """``VectorServer(engine)``, the reference's call shape, serves a CPU
    engine on ``engine.device`` (no card is consulted: the engine's build
    already asked for the CPU) and returns the reference server's ids."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((256, 8)).astype(np.float32)
    Q = X[:3] + 0.05
    fields = dict(k=3, executor="batch-matmul")
    te = VectorSearchEngine.build(X, pruner="linear", capacity=64, **CPU)
    je = JEngine.build(X, pruner="linear", capacity=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = {}
    for who, srv in (("ref", JServer(je, spec=JSpec(kernel="jnp", **fields))),
                     ("port", VectorServer(te, spec=SearchSpec(**fields)))):
        with srv:
            res = [srv.search(q) for q in Q]
        out[who] = (np.stack([np.asarray(r[0]) for r in res]),
                    np.stack([np.asarray(r[1]) for r in res]))
        if who == "port":
            assert srv.device == te.device == torch.device("cpu")
    assert_same_results(out["ref"][0], out["ref"][1], out["port"][0], out["port"][1])


def test_server_surfaces_a_failing_prepare_on_the_futures(monkeypatch):
    """An exception in the batcher's host half reaches the batch's futures
    (nothing hangs), and the server keeps serving afterwards."""
    eng, X = _vec_engine(n=256, dim=8)
    spec = eng.spec.replace(k=3, executor="batch-matmul")
    with VectorServer(eng, spec=spec, max_batch=4) as srv:
        real = srv._prepare

        def boom(*a, **kw):
            srv._prepare = real
            raise RuntimeError("prepare failed")

        srv._prepare = boom
        with pytest.raises(RuntimeError, match="prepare failed"):
            srv.search(X[0])
        ids, _ = srv.search(X[1])
        assert ids[0] == 1


def test_first_search_counts_a_setup_and_a_repeat_does_not():
    """The set-up counter is live: a fresh engine's first int8 search
    builds a mirror (and with it the count moves); the same search again
    builds nothing."""
    eng, X = _vec_engine(n=512, dim=16)
    spec = SearchSpec(k=5, scan_dtype="int8")
    n0 = jit_compile_count()
    kinds0 = setups.by_kind()
    eng.search(X[:4], spec)
    assert jit_compile_count() > n0
    assert setups.by_kind().get("device_mirror", 0) > kinds0.get("device_mirror", 0)
    n1 = jit_compile_count()
    eng.search(X[4:8], spec)
    eng.search(X[8], spec)
    assert jit_compile_count() == n1


def _ivf_engine(n=4000, d=32, nlist=16, seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((nlist, d)).astype(np.float32) * 4
    X = (cents[rng.integers(0, nlist, n)]
         + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)
    eng = VectorSearchEngine.build(X, index="ivf", nlist=nlist, pruner="linear",
                                   capacity=64, **CPU)
    return eng, X


@pytest.mark.parametrize("kind", ["plain", "cascade", "tiered"])
def test_no_setup_after_warmup(kind):
    """After ``warmup()`` no served batch builds anything, for a plain, a
    cascade (ladder proj8:int8 -> int4 -> f32) and a tiered spec, with
    batches of every bucket size served."""
    if kind == "tiered":
        eng, X = _ivf_engine()
        spec = SearchSpec(k=5, nprobe=4, hbm_slots=48, scan_dtype="int8")
    else:
        eng, X = _vec_engine()
        spec = (eng.spec.replace(k=5, executor="batch-matmul") if kind == "plain"
                else SearchSpec(k=5, cascade=("proj8:int8", "int4", "f32")))
    with VectorServer(eng, spec=spec, max_batch=8) as srv:
        warm = srv.warmup()
        assert sorted(warm) == [1, 2, 4, 8]
        futs = [srv.submit(X[i]) for i in range(21)]
        for i, f in enumerate(futs):
            ids, _ = f.result(timeout=30)
            assert ids[0] == i
        assert srv.jit_compiles_since_warmup() == 0


# ------------------------------------------------- parity on identical state
@pytest.fixture(scope="module")
def pair():
    """A reference IVF engine at 2048 x 32 (8 buckets, ADSampling) and its
    port twin carried over through ``convert.engine_from_arrays``; a
    reference flat engine at 1024 x 32 and its twin."""
    rng = np.random.default_rng(4)
    cents = rng.standard_normal((8, 32)).astype(np.float32) * 4
    Xi = (cents[rng.integers(0, 8, 2048)]
          + rng.standard_normal((2048, 32)).astype(np.float32)).astype(np.float32)
    ivf = JEngine.build(Xi, index="ivf", pruner="adsampling", capacity=128, nlist=8)
    Xf = rng.standard_normal((1024, 32)).astype(np.float32)
    flat = JEngine.build(Xf, pruner="adsampling", capacity=256)
    return {
        "ivf": (ivf, engine_from_arrays(ref_arrays(ivf), device="cpu"), Xi),
        "flat": (flat, engine_from_arrays(ref_arrays(flat), device="cpu"), Xf),
    }


# (engine, spec fields, reference kernel): every ported executor
PREPARED = {
    "adaptive": ("ivf", dict(k=5, nprobe=3, executor="adaptive"), "jnp"),
    "jit-masked": ("flat", dict(k=5, executor="jit-masked"), "jnp"),
    "batch-matmul": ("flat", dict(k=5, executor="batch-matmul"), "jnp"),
    "fused-scan": ("ivf", dict(k=5, scan_dtype="int8", executor="fused-scan"), "jnp"),
    "fused-batch": ("ivf", dict(k=5, scan_dtype="int8", executor="fused-batch"), "jnp"),
    "cascade-scan": ("ivf", dict(k=5, cascade=("proj8:int8", "int4", "f32"),
                                 executor="cascade-scan"), "jnp"),
    "cascade-batch": ("ivf", dict(k=5, cascade=("proj8:int8", "int4", "f32"),
                                  executor="cascade-batch"), "jnp"),
    "tiered-scan": ("ivf", dict(k=5, nprobe=3, hbm_slots=24, scan_dtype="int8"), "jnp"),
}


@pytest.mark.parametrize("executor", sorted(PREPARED))
def test_prepare_execute_equals_execute_and_the_reference(pair, executor):
    kind, fields, jkernel = PREPARED[executor]
    je, te, X = pair[kind]
    Q = X[100:104] + 0.05
    spec = SearchSpec(**fields)
    plan = tplan.plan_search(spec, te.store, len(Q), pruner=te.pruner, ivf=te.ivf)
    assert plan.executor == executor
    Qt = torch.from_numpy(Q)
    prepared = tplan.prepare_execute(plan, spec, te.store, te.pruner, Qt, ivf=te.ivf)
    assert isinstance(prepared, tplan.PreparedSearch) and prepared.plan is plan
    got_i, got_d = prepared.run()
    want_i, want_d = tplan.execute(plan, spec, te.store, te.pruner, Qt, ivf=te.ivf)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)

    jspec = JSpec(kernel=jkernel, **fields)
    jp = jplan.plan_search(jspec, je.store, len(Q), pruner=je.pruner, ivf=je.ivf)
    assert jp.executor == executor
    ref_i, ref_d = jplan.prepare_execute(
        jp, jspec, je.store, je.pruner, jplan.jnp.asarray(Q), ivf=je.ivf).run()
    assert_same_results(np.asarray(ref_i), np.asarray(ref_d), got_i, got_d)


def test_tiered_prepare_of_the_next_batch_that_steals_slots(pair):
    """``prepare(N+1)`` admits N+1's buckets into a pool too small for
    both batches, evicting N's before ``run(N)``: N re-admits them and
    returns its blocking ids, and N+1 then returns its own."""
    _, te, X = pair["ivf"]
    Qt = te.pruner.transform_batch(torch.from_numpy(X))
    sel = np.asarray(te.ivf.route_batch(Qt, 2))
    a = 0
    b = next(i for i in range(len(X)) if not set(sel[i]) & set(sel[a]))
    cnts = np.asarray(te.ivf.part_counts)
    demand = [int(cnts[sel[i]].sum()) for i in (a, b)]
    # room for either batch's buckets, not for both
    spec = SearchSpec(k=5, nprobe=2, hbm_slots=max(demand), scan_dtype="int8")
    assert sum(demand) > max(demand)
    QN, QN1 = torch.from_numpy(X[a:a + 1]), torch.from_numpy(X[b:b + 1])
    store, pruner, ivf = te.store, te.pruner, te.ivf

    def blocking(Q):
        plan = tplan.plan_search(spec, store, 1, pruner=pruner, ivf=ivf)
        return tplan.execute(plan, spec, store, pruner, Q, ivf=ivf)

    want_n, want_n1 = blocking(QN), blocking(QN1)
    plan = tplan.plan_search(spec, store, 1, pruner=pruner, ivf=ivf)
    store._tiered_cache = {}
    pn = tplan.prepare_execute(plan, spec, store, pruner, QN, ivf=ivf)
    pn1 = tplan.prepare_execute(plan, spec, store, pruner, QN1, ivf=ivf)
    cache = next(iter(store._tiered_cache.values()))
    assert not cache.resident_ok(sel[a][sel[a] >= 0])  # N's buckets were taken
    got_n, got_n1 = pn.run(), pn1.run()
    for got, want in ((got_n, want_n), (got_n1, want_n1)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", ["plain", "fused", "cascade", "tiered"])
def test_warm_shapes_returns_the_reference_executors(pair, name):
    kind, fields = {
        "plain": ("flat", dict(k=5)),
        "fused": ("ivf", dict(k=5, scan_dtype="int8")),
        "cascade": ("ivf", dict(k=5, cascade=("int8", "f32"))),
        "tiered": ("ivf", dict(k=5, nprobe=3, hbm_slots=24, scan_dtype="int8")),
    }[name]
    je, te, _ = pair[kind]
    buckets = [1, 2, 4] if name == "cascade" else [1, 2, 4, 8]
    want = jplan.warm_shapes(JSpec(kernel="jnp", **fields), je.store, je.pruner,
                             buckets, ivf=je.ivf)
    got = tplan.warm_shapes(SearchSpec(**fields), te.store, te.pruner, buckets,
                            ivf=te.ivf)
    assert got == want


@pytest.mark.parametrize("name", ["fused-batch", "cascade", "tiered"])
def test_port_server_serves_the_reference_servers_ids(pair, name):
    """A closed-loop burst of 8 queries drains as one bucket-8 batch in
    both servers (the window is long and the batch fills it), and then one
    single query as a bucket of 1: the same ids from both."""
    fields = {
        "fused-batch": dict(k=5, scan_dtype="int8"),
        "cascade": dict(k=5, cascade=("proj8:int8", "int4", "f32")),
        "tiered": dict(k=5, nprobe=3, hbm_slots=24, scan_dtype="int8"),
    }[name]
    je, te, X = pair["ivf"]
    Q = X[200:209] + 0.05
    out = {}
    for who, srv in (
        ("ref", JServer(je, spec=JSpec(kernel="jnp", **fields), max_batch=8,
                        flush_interval_s=5.0)),
        ("port", VectorServer(te, spec=SearchSpec(**fields), max_batch=8,
                              flush_interval_s=5.0)),
    ):
        burst = [srv.submit(q) for q in Q[:8]]
        res = [f.result(timeout=30) for f in burst]
        single = srv.submit(Q[8])
        srv.close()  # the draining close ends the single query's window
        res.append(single.result(timeout=30))
        out[who] = (np.stack([np.asarray(r[0]) for r in res]),
                    np.stack([np.asarray(r[1]) for r in res]))
    assert_same_results(out["ref"][0], out["ref"][1], out["port"][0], out["port"][1])


def test_concurrent_tiered_serving_equals_blocking_search():
    """Open-loop tiered traffic through the server, so the batcher's
    prepare of the next batch runs while the executor scans the current
    one over a pool that cannot hold both: every query's ids equal a
    blocking search of it alone."""
    eng, X = _ivf_engine()
    spec = SearchSpec(k=5, nprobe=4, hbm_slots=24, scan_dtype="int8")
    rng = np.random.default_rng(3)
    Q = X[rng.permutation(len(X))[:48]] + 0.05
    want = np.stack([eng.search(q, spec).ids for q in Q])
    got = [None] * len(Q)
    with VectorServer(eng, spec=spec, max_batch=4, flush_interval_s=0.0) as srv:
        futs = [srv.submit(q) for q in Q]
        for i, f in enumerate(futs):
            got[i] = f.result(timeout=30)[0]
    np.testing.assert_array_equal(np.stack(got), want)
