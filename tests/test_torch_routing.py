"""The port's bucket-routed search (``repro_torch.dist.routing`` and the
``routed_bucket`` / ``routed_tiered`` executors) against the reference's.

In this process: the host-side exchange plan, the packed send buffer and
the wire model equal the reference's exactly on balanced, skewed (spilled)
and tree-padded ``sel``; the planner's picks and reasons equal the
reference's; the executor registry is the reference's; and on a world of
one gloo rank the routed executors equal their single-device twins.

On spawned worlds of 8 gloo ranks (``test_torch_dist.run_world``, the
reference beside them on 8 fake devices) the routed cases of
``tests/test_routing.py`` and ``tests/test_quantized.py``: parity with
single-host IVF, the spill, the collective gate, churn, bf16/int8.

Tolerances: ids equal the reference's exactly.  Distances within rtol
1e-5 plus atol 1e-3: the f32 shard scan returns the matrix-product form
``||q||² - 2 q·x + ||x||²`` as the reference's does, and at these data's
norms (``||x||²`` in the hundreds) the two packages' f32 products, summed
in different orders, differ by up to about 1e-4 absolute.  Quantized scans
(bf16/int8) re-rank on the rank in exact f32 (differences, not products),
so their ids equal the reference's at full probe, at the same tolerance.
"""
import textwrap

import numpy as np
import pytest
import torch

import repro.core.engine  # noqa: F401  (breaks the engine<->ivf import cycle)
from repro.core import plan as jplan
from repro.dist import routing as jrouting
from repro.obs import meters as jmeters
from repro_torch.core import plan as tplan
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.data.synthetic import make_dataset
from repro_torch.dist import routing as trouting
from repro_torch.obs import meters as tmeters

from test_torch_dist import run_world

RTOL, ATOL = 1e-5, 1e-3


def _same(got: dict, ref: dict, keys) -> None:
    for key in keys:
        if key.startswith("ids"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=ATOL,
                                       err_msg=key)


def _sel_cases():
    rng = np.random.default_rng(0)
    n_sh, nb = 4, 12
    bucket_parts = rng.integers(1, 6, nb)
    bucket_parts[3] = 0                               # an empty bucket
    bucket_shard = np.arange(nb) % n_sh
    balanced = np.stack([rng.permutation(nb)[:3] for _ in range(16)])
    skewed = np.zeros((33, 2), np.int64)              # demand 9 -> (8, 4)
    skewed[:, 1] = 5
    padded = np.stack([rng.permutation(nb)[:4] for _ in range(10)])
    padded[::2, 2:] = -1                              # tree routing's -1 pads
    padded[1, 0] = 3                                  # routed to the empty one
    return {"balanced": balanced, "skewed": skewed, "tree_padded": padded}, \
        bucket_shard, bucket_parts, n_sh


@pytest.mark.parametrize("case", ["balanced", "skewed", "tree_padded"])
def test_plan_routing_and_wire_model_equal_the_reference(case):
    """``plan_routing``, ``build_send_buffer`` and ``routed_batch_bytes``
    are host NumPy copied line for line: equal to the reference's."""
    cases, bucket_shard, bucket_parts, n_sh = _sel_cases()
    sel = cases[case]
    want = jrouting.plan_routing(sel, bucket_shard, bucket_parts, n_sh)
    got = trouting.plan_routing(sel, bucket_shard, bucket_parts, n_sh)
    for f in ("send_slot", "dest_shard", "dest_slot", "src_of"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert (got.budget, got.occupancy, got.round_budgets) == (
        want.budget, want.occupancy, want.round_budgets)
    if case == "skewed":
        assert got.round_budgets == (8, 4)
    Q = np.random.default_rng(1).standard_normal((len(sel), 8)).astype(np.float32)
    buf = trouting.build_send_buffer(Q, sel, got)
    ref = jrouting.build_send_buffer(Q, sel, want)
    assert buf.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(buf.view(np.int32), ref.view(np.int32))
    for quantized, bpv in ((False, 4.0), (True, 1.0), (True, 0.5)):
        kw = dict(n_shards=n_sh, D=8, C=64, num_slots=24, nprobe=sel.shape[1],
                  k=5, bytes_per_value=bpv, quantized=quantized)
        assert tmeters.routed_batch_bytes(got, **kw) == jmeters.routed_batch_bytes(want, **kw)


def test_plan_routing_spills_oversubscribed_budgets():
    """``tests/test_routing.py::test_plan_routing_spills_oversubscribed_budgets``:
    balanced demand stays one round; 33 queries on one bucket spill to
    (8, 4), 12 slots per pair against one padded round's 16."""
    bucket_shard = np.asarray([0, 1, 2, 3])
    bucket_parts = np.asarray([2, 2, 2, 2])
    sel = np.tile(np.arange(4), (16, 1))
    rp = trouting.plan_routing(sel, bucket_shard, bucket_parts, 4)
    assert rp.round_budgets[1] == 0 and rp.budget == rp.round_budgets[0]
    sel = np.zeros((33, 1), np.int64)
    rp = trouting.plan_routing(sel, bucket_shard, bucket_parts, 4)
    assert rp.round_budgets == (8, 4)
    assert rp.budget == 12 and rp.budget < trouting._pow2_at_least(9)
    buf = trouting.build_send_buffer(np.zeros((33, 8), np.float32), sel, rp)
    assert buf.shape == (4, 4, 12, 8 + 1)
    assert buf.nbytes == 4 * 4 * 16 * (8 + 1) * 4 * 3 // 4


def test_executor_registry_equals_the_reference():
    assert sorted(tplan.executor_names()) == sorted(jplan.executor_names())


class _FakeMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process, torn down after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_planner_routes_ivf_on_data_mesh_with_the_reference_reasons(world_of_one):
    """``tests/test_routing.py::test_planner_routes_ivf_on_data_mesh``: on a
    "data" mesh an IVF engine plans routed_bucket (routed_tiered with
    ``hbm_slots``), ``routing="broadcast"`` and a mesh without a "data"
    axis keep routing on the host; every reason is the reference's."""
    from repro.core.engine import VectorSearchEngine as JEngine
    from repro.core.spec import SearchSpec as JSpec
    from repro_torch.dist import make_mesh

    X, _ = make_dataset(512, 16, "normal", n_queries=1, seed=5)
    store = VectorSearchEngine.build(X, pruner="linear", capacity=64,
                                     device="cpu").store
    jstore = JEngine.build(X, pruner="linear", capacity=64).store
    data = make_mesh((1,), ("data",), device="cpu")
    model = make_mesh((1,), ("model",), device="cpu")
    cases = [
        (dict(k=5), 4, data, _FakeMesh(data=1), "routed_bucket"),
        (dict(k=5, hbm_slots=32, nprobe=3), 4, data, _FakeMesh(data=1), "routed_tiered"),
        (dict(k=5, routing="broadcast"), 4, data, _FakeMesh(data=1), "adaptive"),
        (dict(k=5), 1, model, _FakeMesh(model=1), "adaptive"),
        (dict(k=5, scan_dtype="int8"), 4, data, _FakeMesh(data=1), "routed_bucket"),
        (dict(k=5, scan_dtype="int8", hbm_slots=8), 4, data, _FakeMesh(data=1),
         "routed_tiered"),
    ]
    for kw, n, mesh, jmesh, executor in cases:
        got = tplan.plan_search(SearchSpec(**kw), store, n, ivf=object(), mesh=mesh)
        want = jplan.plan_search(JSpec(**kw), jstore, n, ivf=object(), mesh=jmesh)
        assert got.executor == want.executor == executor, (kw, got, want)
        assert got.reason == want.reason, (got.reason, want.reason)


def test_routed_executors_refuse_kernel_torch_on_a_cuda_store(monkeypatch, world_of_one):
    """routed_tiered always, and routed_bucket off f32, run K2 on the card:
    ``kernel="torch"`` on a CUDA store refuses them, as it refuses
    quantized batch-block-sharded; f32 routed_bucket is plain torch."""
    from repro_torch.dist import make_mesh

    X, Q = make_dataset(512, 16, "clustered", n_queries=2, seed=5)
    eng = VectorSearchEngine.build(X, index="ivf", nlist=4, pruner="linear",
                                   capacity=64, device="cpu")
    mesh = make_mesh((1,), ("data",), device="cpu")
    monkeypatch.setattr(tplan, "_on_cuda", lambda store: True)
    for kw in (dict(scan_dtype="int8"), dict(hbm_slots=8)):
        with pytest.raises(ValueError, match="kernel='torch'"):
            eng.plan(Q, SearchSpec(kernel="torch", **kw), mesh=mesh)
    assert eng.plan(Q, SearchSpec(kernel="torch"), mesh=mesh).executor == "routed_bucket"


def _ivf_engine(mesh, n=2048, nq=40, nlist=16, seed=0):
    X, Q = make_dataset(n, 32, "clustered", n_queries=nq, seed=seed)
    return VectorSearchEngine.build(X, index="ivf", pruner="linear", capacity=64,
                                    nlist=nlist, mesh=mesh, device="cpu"), X, Q


def test_routed_bucket_on_a_world_of_one_equals_single_device_ivf(world_of_one):
    """On a world of one rank every query is routed to rank 0: routed_bucket
    gives the single-device IVF answer (``adaptive`` at the same nprobe,
    ids as sets, as the reference's 8-device test compares), at f32,
    bf16 and int8; a skewed batch spills into two all-to-all rounds and
    each of its rows equals the same row of an unspilled batch; the
    issued collectives are one all-to-all per round and one all-gather."""
    from repro_torch.core.plan import _get_placement
    from repro_torch.dist import make_mesh
    from repro_torch.obs.meters import collective_counts

    mesh = make_mesh((1,), ("data",), device="cpu")
    eng, X, Q = _ivf_engine(mesh)
    host = VectorSearchEngine.build(X, index="ivf", pruner="linear", capacity=64,
                                    nlist=16, device="cpu")
    pl = _get_placement(eng.store, 1, "bucket", ivf=eng.ivf)
    for dt in ("f32", "bf16", "int8"):
        for nprobe in (1, 4):
            spec = SearchSpec(k=5, nprobe=nprobe, scan_dtype=dt)
            got = eng.search(Q[:16], spec)
            assert got.plan.executor == "routed_bucket"
            want = host.search(Q[:16], SearchSpec(k=5, nprobe=nprobe, executor="adaptive"))
            for a, b in zip(got.ids, want.ids):
                assert set(a.tolist()) == set(b.tolist()), (dt, nprobe)
            np.testing.assert_allclose(np.sort(got.dists, 1), np.sort(want.dists, 1),
                                       rtol=1e-4, atol=1e-4)
    # B = 16 fills a budget of 16 (one round); B = 40 demands 40 slots of
    # one rank and spills to (32, 16)
    for B, rounds in ((16, (16, 0)), (40, (32, 16))):
        sel = eng.ivf.route_batch(torch.from_numpy(Q[:B]), 8)
        rp = trouting.plan_routing(sel, pl.bucket_shard, pl.bucket_parts, 1)
        assert rp.round_budgets == rounds
        counts = collective_counts(lambda: eng.search(Q[:B], SearchSpec(k=5, nprobe=8)))
        assert counts == {"all_to_all": 1 + (rounds[1] > 0), "all_gather": 1}, counts
    spec = SearchSpec(k=5, nprobe=8, scan_dtype="int8")
    spilled, single = eng.search(Q[:40], spec), eng.search(Q[:16], spec)
    np.testing.assert_array_equal(spilled.ids[:16], single.ids)
    np.testing.assert_array_equal(spilled.dists[:16], single.dists)


def test_routed_tiered_on_a_world_of_one_equals_tiered_scan(world_of_one):
    """One region holds the whole pool and the merge takes one block: on a
    world of one, routed_tiered gives tiered-scan's ids and distances bit
    for bit (both on one warm cache), with one all-gather per step."""
    from repro_torch.dist import make_mesh
    from repro_torch.obs.meters import collective_counts

    mesh = make_mesh((1,), ("data",), device="cpu")
    eng, _, Q = _ivf_engine(mesh, nq=32)
    for dt in ("f32", "int8"):
        spec = SearchSpec(k=5, nprobe=4, hbm_slots=12, scan_dtype=dt)
        for lo in (0, 16):
            want = eng.search(Q[lo:lo + 16], spec.replace(executor="tiered-scan"))
            got = eng.search(Q[lo:lo + 16], spec)
            assert got.plan.executor == "routed_tiered"
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.dists, want.dists)
        launch = tplan._prepare_tiered_host(eng.store, eng.pruner,
                                            torch.from_numpy(Q[:16]), spec, ivf=eng.ivf)
        tplan._run_tiered_device(launch, eng.store, spec, ivf=eng.ivf, stats=None)
        steps = len(tplan._tiered_steps(launch))
        counts = collective_counts(lambda: eng.search(Q[:16], spec))
        assert counts == {"all_gather": steps}, (counts, steps)


def test_prepare_execute_splits_the_routed_executors(world_of_one):
    """``prepare_execute(...).run()`` equals ``execute`` for both routed
    executors: the host half plans (routing, packing, the first pass's
    issue) and issues no collective; ``run()`` issues them."""
    from repro_torch.dist import make_mesh
    from repro_torch.obs.meters import collective_counts

    mesh = make_mesh((1,), ("data",), device="cpu")
    eng, _, Q = _ivf_engine(mesh, nq=16)
    Qt = torch.from_numpy(Q)
    for spec in (SearchSpec(k=5, nprobe=4, scan_dtype="int8"),
                 SearchSpec(k=5, nprobe=4, hbm_slots=12)):
        plan = eng.plan(Q, spec)
        want = tplan.execute(plan, spec, eng.store, eng.pruner, Qt, ivf=eng.ivf, mesh=mesh)
        box = {}
        assert collective_counts(lambda: box.update(p=tplan.prepare_execute(
            plan, spec, eng.store, eng.pruner, Qt, ivf=eng.ivf, mesh=mesh))) == {}
        got = {}
        assert collective_counts(lambda: got.update(r=box["p"].run()))
        for a, b in zip(got["r"], want):
            np.testing.assert_array_equal(a, b)


def test_vector_server_serves_a_world_of_one(world_of_one):
    """A mesh of one rank forms its batches alone, so ``VectorServer``
    serves it: the served ids are ``engine.search``'s through
    routed_bucket (a mesh of more ranks is refused: ``tests/
    test_torch_dist.py::test_vector_server_refuses_a_mesh_of_more_than_one_rank``)."""
    from repro_torch.dist import make_mesh
    from repro_torch.serve import VectorServer

    mesh = make_mesh((1,), ("data",), device="cpu")
    eng, _, Q = _ivf_engine(mesh, nq=8)
    spec = SearchSpec(k=5, nprobe=4)
    want = eng.search(Q, spec)
    assert want.plan.executor == "routed_bucket"
    with VectorServer(eng, spec=spec, max_batch=8) as srv:
        futs = [srv.submit(q) for q in Q]
        got = [f.result(timeout=60) for f in futs]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]), want.ids)


# ----------------------------------------------------- 8 gloo ranks
_PORT_PRE = """
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.core.pdxearch import SearchStats
from repro_torch.data.synthetic import ground_truth, make_dataset

mesh = make_mesh((8,), ("data",), device="cpu")

def build(X, **kw):
    return VectorSearchEngine.build(X, device="cpu", **kw)
"""
_REF_PRE = """
from repro.core.engine import SearchSpec, VectorSearchEngine
from repro.core.pdxearch import SearchStats
from repro.data.synthetic import ground_truth, make_dataset

mesh = jax.make_mesh((8,), ("data",))
build = VectorSearchEngine.build
"""


def _code(*parts: str) -> str:
    return "\n".join(textwrap.dedent(p) for p in parts)


def _world(tmp_path, body: str):
    return run_world(tmp_path, _code(_PORT_PRE, body), _code(_REF_PRE, body))


def test_routed_bucket_matches_the_reference(tmp_path):
    """``tests/test_routing.py::test_routed_bucket_matches_single_host_ivf_8dev``:
    full probe (exact against ground truth), nprobe 1 and 4, a single
    query, and the broadcast opt-out; every answer the reference's."""
    got, ref = _world(tmp_path, """
    X, Q = make_dataset(2048, 32, "clustered", n_queries=6, seed=0)
    nlist = 16
    eng = build(X, index="ivf", pruner="linear", capacity=64, nlist=nlist, mesh=mesh)
    plans = []
    for nprobe in (nlist, 1, 4):
        r = eng.search(Q, SearchSpec(k=5, nprobe=nprobe))
        plans.append(r.plan.executor)
        out[f"ids_{nprobe}"], out[f"d_{nprobe}"] = np.asarray(r.ids), np.asarray(r.dists)
    r1 = eng.search(Q[0], SearchSpec(k=5, nprobe=nlist))
    plans.append(r1.plan.executor)
    out["ids_one"], out["d_one"] = np.asarray(r1.ids), np.asarray(r1.dists)
    rb = eng.search(Q, SearchSpec(k=5, routing="broadcast"))
    plans.append(rb.plan.executor)
    out["ids_bc"], out["d_bc"] = np.asarray(rb.ids), np.asarray(rb.dists)
    out["gt"] = ground_truth(X, Q, k=5)[0]
    out["plans"] = np.array(plans)
    """)
    assert got["plans"].tolist() == ref["plans"].tolist() == ["routed_bucket"] * 4 + [
        "adaptive"]
    np.testing.assert_array_equal(np.sort(got["ids_16"], 1), np.sort(got["gt"], 1))
    _same(got, ref, [f"{a}_{t}" for a in ("ids", "d") for t in (16, 1, 4, "one", "bc")])


def test_spilled_routing_matches_the_reference(tmp_path):
    """``tests/test_routing.py::test_spilled_routing_matches_single_round_8dev``:
    24 near-copies of one vector route to one bucket, the plan spills into
    two all-to-all rounds, and the answer is the reference's (and the
    single-host IVF's)."""
    body = """
    X, _ = make_dataset(2048, 32, "clustered", n_queries=1, seed=3)
    rng = np.random.default_rng(11)
    Q = (X[0][None] + rng.normal(0, 0.01, (24, 32))).astype(np.float32)
    eng = build(X, index="ivf", pruner="linear", capacity=64, nlist=16, mesh=mesh)
    pl = _get_placement(eng.store, 8, "bucket", ivf=eng.ivf)
    sel = eng.ivf.route_batch(as_q(Q), 1)
    rp = plan_routing(sel, pl.bucket_shard, pl.bucket_parts, 8)
    out["rounds"] = np.array(rp.round_budgets)
    res = eng.search(Q, SearchSpec(k=5, nprobe=1))
    assert res.plan.executor == "routed_bucket", res.plan
    out["ids"], out["d"] = np.asarray(res.ids), np.asarray(res.dists)
    host = build(X, index="ivf", pruner="linear", capacity=64, nlist=16)
    want = host.search(Q, SearchSpec(k=5, nprobe=1, executor="adaptive"))
    out["ids_host"] = np.asarray(want.ids)
    """
    got, ref = run_world(tmp_path, _code(_PORT_PRE, """
    from repro_torch.core.plan import _get_placement
    from repro_torch.dist.routing import plan_routing
    from repro_torch.obs.meters import collective_counts
    as_q = torch.from_numpy
    """, body, """
    counts = collective_counts(lambda: eng.search(Q, SearchSpec(k=5, nprobe=1)))
    assert counts == {"all_to_all": 2, "all_gather": 1}, counts
    """), _code(_REF_PRE, """
    from repro.core.plan import _get_placement
    from repro.dist.routing import plan_routing
    as_q = jnp.asarray
    """, body))
    assert got["rounds"].tolist() == ref["rounds"].tolist() and got["rounds"][1] > 0
    _same(got, ref, ["ids", "d"])
    for a, b in zip(got["ids"], got["ids_host"]):
        assert set(a.tolist()) == set(b.tolist())


def test_routed_bucket_collective_gate(tmp_path):
    """``tests/test_routing.py::test_routed_bucket_one_alltoall_one_allgather_8dev``
    and ``::test_routed_bucket_quantized_routing_keeps_collective_gate_8dev``:
    the bound routed function issues one all-to-all and one all-gather
    whatever B and nprobe (the reference's plans here never spill); with
    int8 centroid routing the engine's metered counts are one of each per
    batch and full probe stays exact."""
    body = """
    X, Q = make_dataset(2048, 32, "clustered", n_queries=16, seed=1)
    eng = build(X, index="ivf", pruner="linear", capacity=64, nlist=16, mesh=mesh)
    pl = _get_placement(eng.store, 8, "bucket", ivf=eng.ivf)
    rounds = []
    for B in (2, 4, 16):
        for nprobe in (1, 4, 16):
            sel = eng.ivf.route_batch(as_q(Q[:B]), nprobe)
            rp = plan_routing(sel, pl.bucket_shard, pl.bucket_parts, 8)
            rounds.append(rp.round_budgets)
            fn = make_routed_fn(mesh, pl, rp, Q.shape[1], sel.shape[1], 5)
            buf = build_send_buffer(Q[:B], sel, rp)
            assert gate(fn, buf) == {"all_to_all": 1, "all_gather": 1}, (B, nprobe)
    out["rounds"] = np.array(rounds)
    metrics.set_enabled(True)
    X, Q = make_dataset(2048, 32, "clustered", n_queries=6, seed=0)
    eng = build(X, index="ivf", pruner="linear", capacity=64, nlist=16, mesh=mesh)
    reg = metrics.get_registry()
    res = eng.search(Q, SearchSpec(k=5, nprobe=16, route_dtype="int8"))
    assert res.plan.executor == "routed_bucket", res.plan
    out["ids_full"] = np.asarray(res.ids)
    out["gt"] = ground_truth(X, Q, k=5)[0]
    out["issued"] = np.array([reg.get("repro_collectives_issued_total",
                                      executor="routed_bucket", primitive=p)
                              for p in ("all_to_all", "all_gather")])
    out["route_bytes"] = np.array(reg.get("repro_device_bytes_total", executor="route",
                                          component="scan", dtype="int8"))
    rq = eng.search(Q, SearchSpec(k=5, nprobe=4, route_dtype="int8"))
    out["ids_q"], out["d_q"] = np.asarray(rq.ids), np.asarray(rq.dists)
    """
    got, ref = run_world(tmp_path, _code(_PORT_PRE, """
    from repro_torch.core.plan import _get_placement
    from repro_torch.dist.routing import build_send_buffer, make_routed_fn, plan_routing
    from repro_torch.obs import metrics
    from repro_torch.obs.meters import collective_counts
    as_q = torch.from_numpy

    def gate(fn, buf):
        return collective_counts(fn, torch.from_numpy(buf[rank]))
    """, body), _code(_REF_PRE, """
    from repro.core.plan import _get_placement
    from repro.dist.pdx_sharded import collective_counts
    from repro.dist.routing import build_send_buffer, make_routed_fn, plan_routing
    from repro.obs import metrics
    as_q = jnp.asarray

    def gate(fn, buf):
        return collective_counts(fn, jnp.asarray(buf))
    """, body))
    assert got["rounds"].tolist() == ref["rounds"].tolist()
    assert (got["rounds"][:, 1] == 0).all()
    np.testing.assert_array_equal(np.sort(got["ids_full"], 1), np.sort(got["gt"], 1))
    assert got["issued"].tolist() == ref["issued"].tolist() == [1.0, 1.0]
    assert float(got["route_bytes"]) == float(ref["route_bytes"]) > 0
    _same(got, ref, ["ids_full", "ids_q", "d_q"])


def test_routed_bucket_quantized_matches_the_reference(tmp_path):
    """``tests/test_quantized.py::test_routed_bucket_bf16_parity_8dev``: at
    full probe bf16 and int8 give the exact top-k (distances exact after
    the on-shard f32 re-rank), at nprobe 1 and 4 bf16 gives the f32
    routed answer; every answer the reference's."""
    got, ref = _world(tmp_path, """
    X, Q = make_dataset(2048, 32, "clustered", n_queries=6, seed=0)
    nlist = 16
    eng = build(X, index="ivf", pruner="linear", capacity=64, nlist=nlist, mesh=mesh)
    out["gt"], out["gt_d"] = ground_truth(X, Q, k=5)
    for dt in ("bf16", "int8"):
        res = eng.search(Q, SearchSpec(k=5, nprobe=nlist, scan_dtype=dt))
        assert res.plan.executor == "routed_bucket", res.plan
        out[f"ids_{dt}"], out[f"d_{dt}"] = np.asarray(res.ids), np.asarray(res.dists)
    for nprobe in (1, 4):
        rf = eng.search(Q, SearchSpec(k=5, nprobe=nprobe))
        rq = eng.search(Q, SearchSpec(k=5, nprobe=nprobe, scan_dtype="bf16"))
        out[f"ids_f32_{nprobe}"] = np.asarray(rf.ids)
        out[f"ids_bf16_{nprobe}"], out[f"d_bf16_{nprobe}"] = np.asarray(rq.ids), np.asarray(rq.dists)
    """)
    for dt in ("bf16", "int8"):
        np.testing.assert_array_equal(np.sort(got[f"ids_{dt}"], 1), np.sort(got["gt"], 1))
        np.testing.assert_allclose(np.sort(got[f"d_{dt}"], 1), np.sort(got["gt_d"], 1),
                                   rtol=1e-4, atol=1e-3)
    for nprobe in (1, 4):
        for a, b in zip(got[f"ids_bf16_{nprobe}"], got[f"ids_f32_{nprobe}"]):
            assert set(a.tolist()) == set(b.tolist()), nprobe
    _same(got, ref, ["ids_bf16", "d_bf16", "ids_int8", "d_int8"]
          + [f"{a}_{p}" for a in ("ids_bf16", "d_bf16") for p in (1, 4)])


def test_routed_bucket_parity_under_churn(tmp_path):
    """``tests/test_routing.py::test_routed_bucket_parity_under_churn_8dev``:
    the same churn on both packages; at full probe the routed answer is a
    store rebuilt from the survivors, mid-churn (the write head merged)
    and after ``compact()`` (the placement re-derived); every answer the
    reference's."""
    got, ref = _world(tmp_path, """
    X, Q = make_dataset(2048, 32, "clustered", n_queries=4, seed=2)
    nlist = 8
    eng = build(X, index="ivf", pruner="linear", capacity=64, nlist=nlist, mesh=mesh)
    rows = {i: X[i] for i in range(len(X))}
    rng = np.random.default_rng(77)
    new = rng.standard_normal((50, 32)).astype(np.float32)
    ids = np.asarray(eng.insert(new))
    for r, i in enumerate(ids):
        rows[int(i)] = new[r]
    dels = rng.choice(2048, size=250, replace=False)
    eng.delete(dels)
    for i in dels:
        rows.pop(int(i), None)
    im = np.asarray(sorted(rows))
    Xs = np.stack([rows[i] for i in sorted(rows)])
    host = build(Xs, index="ivf", pruner="linear", capacity=64, nlist=nlist)
    spec = SearchSpec(k=5, nprobe=nlist)
    want = np.asarray(host.search(Q, spec.replace(executor="batch-matmul")).ids)
    out["want"] = im[want]
    for when in ("head", "compacted"):
        if when == "compacted":
            v0 = eng.store.tiles_version
            eng.compact()
            assert eng.store.tiles_version > v0
        r = eng.search(Q, spec)
        assert r.plan.executor == "routed_bucket", r.plan
        out[f"ids_{when}"], out[f"d_{when}"] = np.asarray(r.ids), np.asarray(r.dists)
    """)
    for when in ("head", "compacted"):
        np.testing.assert_array_equal(got[f"ids_{when}"], got["want"])
    _same(got, ref, [f"{a}_{w}" for a in ("ids", "d") for w in ("head", "compacted")])
