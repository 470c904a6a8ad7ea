"""The port's mesh executors against the reference's, on spawned worlds of 8
gloo processes on the CPU (``torch.distributed``; the reference runs 8 fake
CPU devices in a subprocess, as ``tests/test_dist.py`` does).

Each world is 8 processes, one rank each, that rendezvous through a
``file://`` store under ``tmp_path`` (no port to collide under xdist) and
run the same body: the SPMD contract, the same X, seed and Q on every
rank.  Each rank saves its results; every rank's must equal rank 0's, and
rank 0's are held to the reference's, which a subprocess with
``--xla_force_host_platform_device_count=8`` computes at the same time on
the same NumPy-seeded inputs.  A rank or a reference that does not finish
within its join timeout fails its test rather than hanging the suite.

Tolerances: ids equal the reference's exactly; distances within rtol 1e-5
(both sides sum f32 values in different orders).  Dim-sharded sums its
D-slabs in the collective's order, so its ids are compared as sets and its
sorted distances at rtol 1e-5, as the reference test compares them.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
WORLD = 8
# Join limits.  A world runs at a lower priority than the suite's
# workers (``_spawn``), so under the whole suite's load it can take several
# times what it takes alone: the LM world (``tests/test_torch_dist_lm.py``)
# took 35 s alone, 120 s beside seven busy processes, and overran 120 s in
# a whole-suite run.  The gloo timeout matches the join limit, so that a
# rank waiting on a starved peer is not cut first.
JOIN_S = 600      # a port world's ranks, all together
REF_JOIN_S = 600  # the reference subprocess (JAX import and compiles)

_PORT = """
import datetime, os, time
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
_t0 = time.monotonic()
def mark(what):  # where the time went, in the rank's log
    print(f"{time.monotonic() - _t0:8.1f} s  {what}", flush=True)
rank = int(os.environ["RANK"])
dist.init_process_group(
    "gloo", init_method=os.environ["INIT"], rank=rank,
    world_size=int(os.environ["WORLD_SIZE"]),
    timeout=datetime.timedelta(seconds=int(os.environ["GLOO_S"])))
from repro_torch.dist import make_mesh
mark("joined")
out = {}
"""
_PORT_END = """
np.savez(os.path.join(os.environ["OUT"], f"rank{rank}.npz"), **out)
dist.barrier()
dist.destroy_process_group()
mark("done")
"""
_REF = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={WORLD}"
import jax, numpy as np, jax.numpy as jnp
assert jax.device_count() == {WORLD}, jax.devices()
out = {{}}
"""
_REF_END = """
np.savez(os.path.join(os.environ["OUT"], "ref.npz"), **out)
"""


def _spawn(code: str, env: dict, log):
    # the worlds run at a lower priority, so that tests timing themselves
    # on the other workers are not starved by nine extra processes
    return subprocess.Popen(["nice", "-n", "10", sys.executable, "-c", code],
                            env=env, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT)


def run_world(tmp_path, body: str, ref_body: str | None = None):
    """Run ``body`` on a world of 8 gloo ranks (and ``ref_body`` in the
    reference's 8-device subprocess beside it) -> (per-rank result dicts,
    the reference's dict or None)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OUT=str(tmp_path), WORLD_SIZE=str(WORLD),
               INIT=f"file://{tmp_path / 'rendezvous'}", OMP_NUM_THREADS="1",
               GLOO_S=str(JOIN_S))
    env.pop("XLA_FLAGS", None)
    procs = []
    try:
        for r in range(WORLD):
            log = open(tmp_path / f"rank{r}.log", "w")
            procs.append((f"rank {r}", _spawn(
                _PORT + textwrap.dedent(body) + _PORT_END,
                dict(env, RANK=str(r)), log), log, JOIN_S))
        if ref_body is not None:
            log = open(tmp_path / "ref.log", "w")
            procs.append(("reference", _spawn(
                _REF + textwrap.dedent(ref_body) + _REF_END, env, log),
                log, REF_JOIN_S))
        t0 = time.monotonic()
        for name, p, _, limit in procs:
            try:
                p.wait(timeout=max(1.0, limit - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                log = tmp_path / ("ref.log" if name == "reference"
                                  else f"rank{name.split()[-1]}.log")
                pytest.fail(f"{name} did not finish within {limit} s; its log ends:\n"
                            + log.read_text()[-2000:])
        for name, p, log, _ in procs:
            log.close()
            logname = "ref.log" if name == "reference" else f"rank{name.split()[-1]}.log"
            assert p.returncode == 0, (name, (tmp_path / logname).read_text()[-4000:])
    finally:
        for _, p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    for r, got in enumerate(ranks[1:], 1):  # the result is replicated
        assert got.keys() == ranks[0].keys()
        for key in got:
            np.testing.assert_array_equal(got[key], ranks[0][key], err_msg=f"rank {r} {key}")
    ref = dict(np.load(tmp_path / "ref.npz")) if ref_body is not None else None
    return ranks[0], ref


def _same(got: dict, ref: dict, keys) -> None:
    for key in keys:
        if key.startswith("ids"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=key)


def test_block_sharded_search_matches_the_reference(tmp_path):
    """``tests/test_dist.py::test_block_sharded_search_matches_single_device``:
    16 partitions over 8 ranks, two queries; and the same with stats, whose
    computed-values psum must equal the reference's."""
    got, ref = run_world(tmp_path, """
    from repro_torch.core.layout import build_flat_store
    from repro_torch.core.pdxearch import SearchStats
    from repro_torch.core.pruners import make_adsampling
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.dist.pdx_sharded import search_block_sharded

    X, Q = make_dataset(2048, 32, "normal", n_queries=2, seed=0)
    store = build_flat_store(X, capacity=128, device="cpu")
    mesh = make_mesh((8,), ("data",), device="cpu")
    for qi, q in enumerate(Q):
        res = search_block_sharded(mesh, store.data, store.ids,
                                   torch.from_numpy(q), 5)
        out[f"ids{qi}"], out[f"d{qi}"] = res.ids.numpy(), res.dists.numpy()
    pr = make_adsampling(32, eps0=2.1, seed=0, device="cpu")
    st = SearchStats()
    res = search_block_sharded(mesh, store.data, store.ids,
                               torch.from_numpy(Q[0]), 5, pruner=pr, stats=st)
    out["ids_ads"], out["d_ads"] = res.ids.numpy(), res.dists.numpy()
    out["stats"] = np.array([st.values_total, st.values_computed,
                             st.partitions_visited], np.float64)
    """, """
    from repro.core.layout import build_flat_store
    from repro.core.pdxearch import SearchStats
    from repro.core.pruners import make_adsampling
    from repro.data.synthetic import make_dataset
    from repro.dist.pdx_sharded import search_block_sharded

    X, Q = make_dataset(2048, 32, "normal", n_queries=2, seed=0)
    store = build_flat_store(X, capacity=128)
    mesh = jax.make_mesh((8,), ("data",))
    for qi, q in enumerate(Q):
        res = search_block_sharded(mesh, store.data, store.ids, jnp.asarray(q), 5)
        out[f"ids{qi}"], out[f"d{qi}"] = np.asarray(res.ids), np.asarray(res.dists)
    pr = make_adsampling(32, eps0=2.1, seed=0)
    st = SearchStats()
    res = search_block_sharded(mesh, store.data, store.ids, jnp.asarray(Q[0]), 5,
                               pruner=pr, stats=st)
    out["ids_ads"], out["d_ads"] = np.asarray(res.ids), np.asarray(res.dists)
    out["stats"] = np.array([st.values_total, st.values_computed,
                             st.partitions_visited], np.float64)
    """)
    _same(got, ref, ["ids0", "d0", "ids1", "d1", "ids_ads", "d_ads"])
    np.testing.assert_array_equal(got["stats"], ref["stats"])


def test_dim_sharded_search_matches_the_reference(tmp_path):
    """``tests/test_dist.py::test_dim_sharded_search_matches_single_device``:
    D = 64 over 8 "model" ranks; ids as sets, sorted dists at rtol 1e-5."""
    got, ref = run_world(tmp_path, """
    from repro_torch.core.layout import build_flat_store
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.dist.pdx_sharded import search_dim_sharded

    X, Q = make_dataset(1024, 64, "skewed", n_queries=2, seed=1)
    store = build_flat_store(X, capacity=256, device="cpu")
    mesh = make_mesh((8,), ("model",), device="cpu")
    for qi, q in enumerate(Q):
        res = search_dim_sharded(mesh, store.data, store.ids, torch.from_numpy(q), 5)
        out[f"ids{qi}"], out[f"d{qi}"] = res.ids.numpy(), res.dists.numpy()
    """, """
    from repro.core.layout import build_flat_store
    from repro.data.synthetic import make_dataset
    from repro.dist.pdx_sharded import search_dim_sharded

    X, Q = make_dataset(1024, 64, "skewed", n_queries=2, seed=1)
    store = build_flat_store(X, capacity=256)
    mesh = jax.make_mesh((8,), ("model",))
    for qi, q in enumerate(Q):
        res = search_dim_sharded(mesh, store.data, store.ids, jnp.asarray(q), 5)
        out[f"ids{qi}"], out[f"d{qi}"] = np.asarray(res.ids), np.asarray(res.dists)
    """)
    for qi in range(2):
        assert set(got[f"ids{qi}"].tolist()) == set(ref[f"ids{qi}"].tolist())
        np.testing.assert_allclose(np.sort(got[f"d{qi}"]), np.sort(ref[f"d{qi}"]),
                                   rtol=RTOL)


_PLAN_SETUP = """
X, Q = make_dataset(2048, 64, "normal", n_queries=4, seed=0)
spec = SearchSpec(k=5)
"""


def test_planner_picks_the_reference_executors_on_each_mesh(tmp_path):
    """``tests/test_plan.py::test_sharded_executors_match_ground_truth_8dev``:
    the planner's pick on a "data" and a "model" mesh, batched and per
    query, the ids and the SearchStats of each against the reference's; an
    IVF engine on a "data" mesh plans the bucket-routed search with the
    reference's reason, and ``routing="broadcast"`` ignores the mesh with
    the reference's note."""
    body = _PLAN_SETUP + textwrap.dedent("""
    meshes = {"data": make_mesh((8,), ("data",), device="cpu"),
              "model": make_mesh((8,), ("model",), device="cpu")}
    cases = [("data", "linear", Q[0], spec), ("data", "linear", Q, spec),
             ("data", "linear", Q, spec.replace(batch_collectives=False)),
             ("model", "adsampling", Q[0], spec)]
    plans = []
    for i, (axis, pruner, q, sp) in enumerate(cases):
        eng = build(X, pruner=pruner, capacity=128, mesh=meshes[axis])
        st = SearchStats()
        r = eng.search(q, sp, stats=st)
        plans.append(r.plan.executor)
        out[f"ids{i}"], out[f"d{i}"] = np.asarray(r.ids), np.asarray(r.dists)
        out[f"stats{i}"] = np.array([st.values_total, st.values_computed,
                                     st.partitions_visited], np.float64)
    ivf = build(X, index="ivf", nlist=8, pruner="linear", capacity=128,
                mesh=meshes["data"])
    p = ivf.plan(Q, SearchSpec(k=5))
    plans.append(p.executor)
    out["reason_routed"] = np.array(p.reason)
    r = ivf.search(Q[0], spec.replace(routing="broadcast", nprobe=8))
    plans.append(r.plan.executor)
    out["reason"] = np.array(r.plan.reason)
    out["ids_ivf"], out["d_ivf"] = np.asarray(r.ids), np.asarray(r.dists)
    out["plans"] = np.array(plans)
    """)
    got, ref = run_world(tmp_path, textwrap.dedent("""
    from repro_torch.core.engine import SearchSpec, SearchStats, VectorSearchEngine
    from repro_torch.data.synthetic import make_dataset

    def build(X, **kw):
        return VectorSearchEngine.build(X, device="cpu", **kw)
    """) + body, textwrap.dedent("""
    from repro.core.engine import SearchSpec, SearchStats, VectorSearchEngine
    from repro.data.synthetic import make_dataset

    def make_mesh(shape, names, device):
        return jax.make_mesh(shape, names)

    def build(X, **kw):
        return VectorSearchEngine.build(X, **kw)
    """) + body)
    assert got["plans"].tolist() == ref["plans"].tolist() == [
        "block-sharded", "batch-block-sharded", "block-sharded", "dim-sharded",
        "routed_bucket", "adaptive"]
    assert str(got["reason"]).startswith("mesh ignored: spec.routing='broadcast'")
    assert str(got["reason"]) == str(ref["reason"])
    assert str(got["reason_routed"]) == str(ref["reason_routed"])
    _same(got, ref, ["ids0", "d0", "ids1", "d1", "ids2", "d2", "ids_ivf", "d_ivf"])
    assert set(got["ids3"].ravel().tolist()) == set(ref["ids3"].ravel().tolist())
    np.testing.assert_allclose(np.sort(got["d3"]), np.sort(ref["d3"]), rtol=RTOL)
    for i in range(4):
        np.testing.assert_array_equal(got[f"stats{i}"], ref[f"stats{i}"])


def test_batched_executor_one_allgather_per_batch(tmp_path):
    """``tests/test_plan.py::test_batched_executor_one_allgather_per_batch_8dev``:
    one all-gather per batch whatever B, two per query, counted by the
    port's ``collective_counts``; the engine's metered count agrees."""
    got, _ = run_world(tmp_path, """
    from repro_torch.core.engine import SearchSpec, VectorSearchEngine
    from repro_torch.core.layout import build_flat_store
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.dist.pdx_sharded import (search_batch_block_sharded,
                                              search_block_sharded)
    from repro_torch.obs import metrics
    from repro_torch.obs.meters import collective_counts

    X, Q = make_dataset(2048, 32, "normal", n_queries=16, seed=0)
    store = build_flat_store(X, capacity=128, device="cpu")
    mesh = make_mesh((8,), ("data",), device="cpu")
    d, i = store.data, store.ids
    for B in (2, 4, 16):
        counts = collective_counts(
            lambda dd, ii, qq: search_batch_block_sharded(mesh, dd, ii, qq, 5),
            d, i, torch.from_numpy(Q[:B]))
        assert counts == {"all_gather": 1}, (B, counts)
    per_q = collective_counts(
        lambda dd, ii, qq: search_block_sharded(mesh, dd, ii, qq, 5),
        d, i, torch.from_numpy(Q[0]))
    assert per_q == {"all_gather": 2}, per_q
    eng = VectorSearchEngine.build(X, pruner="linear", capacity=128, mesh=mesh,
                                   device="cpu")
    metrics.set_enabled(True)
    eng.search(Q, SearchSpec(k=5))
    snap = metrics.get_registry().snapshot()["counters"]
    out["issued"] = np.array([v for k, v in snap["repro_collectives_issued_total"].items()])
    out["ok"] = np.array(1)
    """)
    assert got["issued"].tolist() == [1.0]


def test_sharded_executor_parity_under_churn(tmp_path):
    """``tests/test_mutable.py::test_sharded_executor_parity_under_churn_8dev``:
    the same churn on both packages; block- and batch-block-sharded give
    the reference's ids before and after ``compact()``, which leaves 15
    partitions, padded over 8 ranks."""
    body = """
    X, Q = make_dataset(2048, 32, "normal", n_queries=4, seed=0)
    eng = build(X, pruner="linear", capacity=128, mesh=mesh)
    rng = np.random.default_rng(9999)
    new = rng.standard_normal((60, 32)).astype(np.float32)
    out["new_ids"] = np.asarray(eng.insert(new))
    eng.delete(rng.choice(2048, size=300, replace=False))
    spec = SearchSpec(k=5)
    plans = []
    for when in ("head", "compacted"):
        if when == "compacted":
            eng.compact()
            out["P"] = np.array(eng.store.num_partitions)
        r1 = eng.search(Q[0], spec)
        rb = eng.search(Q, spec)
        plans += [r1.plan.executor, rb.plan.executor]
        out[f"ids1_{when}"], out[f"d1_{when}"] = np.asarray(r1.ids), np.asarray(r1.dists)
        out[f"idsb_{when}"], out[f"db_{when}"] = np.asarray(rb.ids), np.asarray(rb.dists)
    out["reason"] = np.array(rb.plan.reason)
    out["plans"] = np.array(plans)
    """
    got, ref = run_world(tmp_path, """
    from repro_torch.core.engine import SearchSpec, VectorSearchEngine
    from repro_torch.data.synthetic import make_dataset

    mesh = make_mesh((8,), ("data",), device="cpu")

    def build(X, **kw):
        return VectorSearchEngine.build(X, device="cpu", **kw)
    """ + body, """
    from repro.core.engine import SearchSpec, VectorSearchEngine
    from repro.data.synthetic import make_dataset

    mesh = jax.make_mesh((8,), ("data",))
    build = VectorSearchEngine.build
    """ + body)
    assert got["plans"].tolist() == ref["plans"].tolist() == [
        "block-sharded", "batch-block-sharded"] * 2
    assert int(got["P"]) == int(ref["P"]) and int(got["P"]) % WORLD != 0
    assert "padded" in str(got["reason"]) and str(got["reason"]) == str(ref["reason"])
    np.testing.assert_array_equal(got["new_ids"], ref["new_ids"])
    _same(got, ref, [f"{a}_{w}" for a in ("ids1", "d1", "idsb", "db")
                     for w in ("head", "compacted")])


def test_batch_block_sharded_quantized_one_allgather(tmp_path):
    """``tests/test_quantized.py::test_batch_block_sharded_quantized_one_allgather_8dev``:
    bf16 and int8 batch-block-sharded give the reference's ids (and
    ground truth) after the on-shard f32 re-rank, with one all-gather per
    batch."""
    body = """
    X, Q = make_dataset(2048, 32, "normal", n_queries=8, seed=0)
    eng = build(X, pruner="linear", capacity=128, mesh=mesh)
    for dt in ("bf16", "int8", "int4"):
        res = eng.search(Q, SearchSpec(k=5, scan_dtype=dt))
        assert res.plan.executor == "batch-block-sharded", res.plan
        out[f"ids_{dt}"], out[f"d_{dt}"] = np.asarray(res.ids), np.asarray(res.dists)
    out["gt"] = ground_truth(X, Q, k=5)[0]
    """
    got, ref = run_world(tmp_path, """
    from repro_torch.core.engine import SearchSpec, VectorSearchEngine
    from repro_torch.core.layout import device_mirror
    from repro_torch.core.plan import _get_placement
    from repro_torch.data.synthetic import ground_truth, make_dataset
    from repro_torch.dist.pdx_sharded import search_batch_block_sharded
    from repro_torch.obs.meters import collective_counts

    mesh = make_mesh((8,), ("data",), device="cpu")

    def build(X, **kw):
        return VectorSearchEngine.build(X, device="cpu", **kw)
    """ + body + """
    pl = _get_placement(eng.store, 8, "block")
    mirror = device_mirror(eng.store, "int8")
    counts = collective_counts(
        lambda qq: search_batch_block_sharded(mesh, Q=qq, k=5, placement=pl,
                                              mirror=mirror),
        torch.from_numpy(Q))
    assert counts == {"all_gather": 1}, counts
    """, """
    from repro.core.engine import SearchSpec, VectorSearchEngine
    from repro.data.synthetic import ground_truth, make_dataset

    mesh = jax.make_mesh((8,), ("data",))
    build = VectorSearchEngine.build
    """ + body)
    for dt in ("bf16", "int8"):
        np.testing.assert_array_equal(np.sort(got[f"ids_{dt}"], 1), np.sort(got["gt"], 1))
    _same(got, ref, [f"{a}_{dt}" for a in ("ids", "d") for dt in ("bf16", "int8", "int4")])


def test_routed_tiered_matches_the_reference(tmp_path):
    """``tests/test_tiered.py::test_routed_tiered_capacity_smaller_than_store``:
    a pool of 64 slots (8 per rank) under a store of more partitions plans
    ``routed_tiered``; its f32 ids are ``routed_bucket``'s and, like its
    int8 ids, the reference's; one all-gather per (chunk, pass) step."""
    body = """
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((64, 32)).astype(np.float32) * 4
    X = (cents[rng.integers(0, 64, 8000)]
         + rng.standard_normal((8000, 32)).astype(np.float32)).astype(np.float32)
    Q = (cents[rng.integers(0, 64, 12)]
         + rng.standard_normal((12, 32)).astype(np.float32)).astype(np.float32)
    eng = build(X, index="ivf", nlist=64, pruner="linear", capacity=64, mesh=mesh)
    out["P"] = np.array(eng.store.data.shape[0])
    spec = SearchSpec(k=10, nprobe=4)
    routed = eng.search(Q, spec)
    tiered = spec.replace(hbm_slots=64)
    res = eng.search(Q, tiered)
    res8 = eng.search(Q, tiered.replace(scan_dtype="int8"))
    out["plans"] = np.array([routed.plan.executor, res.plan.executor, res8.plan.executor])
    out["ids_routed"] = np.asarray(routed.ids)
    out["ids_f32"], out["d_f32"] = np.asarray(res.ids), np.asarray(res.dists)
    out["ids_int8"], out["d_int8"] = np.asarray(res8.ids), np.asarray(res8.dists)
    cache = next(iter(eng.store._tiered_cache.values()))
    out["resident"] = np.array(cache.resident_slots)
    """
    got, ref = run_world(tmp_path, """
    from repro_torch.core import plan
    from repro_torch.core.engine import SearchSpec, VectorSearchEngine
    from repro_torch.obs.meters import collective_counts

    mesh = make_mesh((8,), ("data",), device="cpu")

    def build(X, **kw):
        return VectorSearchEngine.build(X, device="cpu", **kw)
    """ + body + """
    launch = plan._prepare_routed_tiered_host(
        eng.store, eng.pruner, torch.from_numpy(Q), tiered, ivf=eng.ivf, mesh=mesh)
    steps = len(plan._tiered_steps(launch))
    plan._run_tiered_device(launch, eng.store, tiered, ivf=eng.ivf, stats=None,
                            mesh=mesh)
    counts = collective_counts(lambda: eng.search(Q, tiered))
    assert counts == {"all_gather": steps}, (counts, steps)
    out["steps"] = np.array(steps)
    """, """
    import repro.core.engine
    from repro.core.engine import VectorSearchEngine
    from repro.core.spec import SearchSpec

    mesh = jax.make_mesh((8,), ("data",))
    build = VectorSearchEngine.build
    """ + body)
    assert int(got["P"]) > 64
    assert got["plans"].tolist() == ref["plans"].tolist() == [
        "routed_bucket", "routed_tiered", "routed_tiered"]
    np.testing.assert_array_equal(got["ids_f32"], got["ids_routed"])
    assert int(got["resident"]) <= 64 and int(got["steps"]) >= 1
    _same(got, ref, ["ids_routed", "ids_f32", "d_f32", "ids_int8", "d_int8"])


def test_routed_collective_meters_and_trace(tmp_path):
    """``tests/test_obs.py::test_routed_collective_meters_and_trace_8dev``:
    three bf16 batches through ``routed_bucket`` with stats account the
    selected buckets' work only, the trace runs plan -> route -> scan with
    the on-shard ``rerank`` and ``merge``, the issued counters are the
    per-call collectives (``collective_counts``, the port's stand-in for
    the reference's jaxpr meter) times the batches, and the bytes per
    component equal the reference's."""
    body = """
    metrics.set_enabled(True)
    X, Q = make_dataset(8192, 32, "clustered", n_queries=16, seed=0)
    eng = build(X, index="ivf", pruner="linear", capacity=128, nlist=32, mesh=mesh)
    reg = metrics.get_registry()
    spec = SearchSpec(k=5, nprobe=4, scan_dtype="bf16")
    stats = SearchStats()
    for _ in range(3):
        res = eng.search(Q, spec, stats=stats)
        assert res.plan.executor == "routed_bucket", res.plan
    out["ids"], out["d"] = np.asarray(res.ids), np.asarray(res.dists)
    out["full"] = np.array(float(np.asarray(eng.store.counts).sum()) * eng.store.dim)
    out["stats"] = np.array([stats.values_total, stats.values_computed,
                             stats.partitions_visited], np.float64)
    qt = res.trace
    out["spans"] = np.array(qt.span_names())
    out["rerank_fused"] = np.array(qt.find("rerank").attrs.get("fused"))
    out["issued"] = np.array([reg.get("repro_collectives_issued_total",
                                      executor="routed_bucket", primitive=p)
                              for p in ("all_to_all", "all_gather")])
    out["bytes"] = np.array([reg.get("repro_device_bytes_total", executor="routed_bucket",
                                     component=c, dtype="bf16")
                             for c in ("scan", "rerank", "all_to_all", "all_gather")])
    """
    got, ref = run_world(tmp_path, """
    from repro_torch.core.engine import SearchSpec, SearchStats, VectorSearchEngine
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.obs import metrics
    from repro_torch.obs.meters import collective_counts

    mesh = make_mesh((8,), ("data",), device="cpu")

    def build(X, **kw):
        return VectorSearchEngine.build(X, device="cpu", **kw)
    """ + body + """
    out["per_call"] = np.array([collective_counts(lambda: eng.search(Q, spec)).get(p, 0)
                                for p in ("all_to_all", "all_gather")])
    """, """
    from repro.core.engine import SearchSpec, VectorSearchEngine
    from repro.core.pdxearch import SearchStats
    from repro.data.synthetic import make_dataset
    from repro.obs import metrics

    mesh = jax.make_mesh((8,), ("data",))
    build = VectorSearchEngine.build
    """ + body)
    total, computed, visited = got["stats"]
    assert 0 < total <= float(got["full"]) * 16 * 3 and computed == total and visited > 0
    np.testing.assert_array_equal(got["stats"], ref["stats"])
    spans = got["spans"].tolist()
    for name in ("plan", "route", "scan", "rerank", "merge"):
        assert name in spans, spans
    assert spans.index("plan") < spans.index("route") < spans.index("scan")
    assert str(got["rerank_fused"]) == "on-shard"
    assert got["per_call"][1] == 1
    assert got["issued"].tolist() == (got["per_call"] * 3).tolist() == ref["issued"].tolist()
    assert (got["bytes"] > 0).all()
    np.testing.assert_array_equal(got["bytes"], ref["bytes"])
    _same(got, ref, ["ids", "d"])


def test_vector_server_refuses_a_mesh_of_more_than_one_rank(tmp_path):
    """The mesh executors are SPMD and the admission batcher cannot promise
    that 8 ranks form the same batches: ``VectorServer`` refuses an engine
    whose mesh spans more than one rank (the reference serves a mesh
    engine from one process), at once and on every rank."""
    got, _ = run_world(tmp_path, """
    from repro_torch.core.engine import VectorSearchEngine
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.serve import VectorServer

    X, Q = make_dataset(2048, 32, "clustered", n_queries=4, seed=0)
    mesh = make_mesh((8,), ("data",), device="cpu")
    eng = VectorSearchEngine.build(X, index="ivf", nlist=16, pruner="linear",
                                   capacity=64, mesh=mesh, device="cpu")
    try:
        VectorServer(eng)
        out["refused"] = np.array("")
    except ValueError as e:
        out["refused"] = np.array(str(e))
    """)
    assert "mesh spans 8 ranks" in str(got["refused"])


def test_compressed_psum_matches_the_reference(tmp_path):
    """``tests/test_dist.py::test_compressed_psum_dp_grads`` on 8 gloo ranks:
    rank r holds row r of one seeded (8, 64) gradient; the int8 all-reduce
    gives every rank the mean within 1.5 quantization steps (the
    reference's bar), and the reference's ``shard_map`` result on the same
    rows (the int32 sum and the shared scale are exact: rtol 1e-6).  Each
    leaf issues one ``pmax`` and two ``psum``s."""
    g = (np.random.default_rng(0).standard_normal((WORLD, 64)) * 0.01).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    got, ref = run_world(tmp_path, f"""
    from repro_torch.obs.meters import collective_counts
    from repro_torch.train.compression import compressed_psum

    g = np.load(os.path.join(os.environ["OUT"], "g.npy"))
    mesh = make_mesh(({WORLD},), ("data",), device="cpu")
    tree = {{"g": torch.from_numpy(g[rank]), "h": {{"b": torch.from_numpy(g[rank, :5] * 3)}}}}
    res = {{}}
    counts = collective_counts(lambda t: res.update(compressed_psum(t, mesh, "data")), tree)
    assert counts == {{"pmax": 2, "psum": 4}}, counts
    out["g"] = res["g"].numpy()
    out["b"] = res["h"]["b"].numpy()
    """, f"""
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.train.compression import compressed_psum

    g = jnp.asarray(np.load(os.path.join(os.environ["OUT"], "g.npy")))
    mesh = jax.make_mesh(({WORLD},), ("data",))
    fn = shard_map(lambda gl: compressed_psum({{"g": gl[0], "b": gl[0, :5] * 3}}, "data"),
                   mesh=mesh, in_specs=(P("data"),), out_specs=P(), check_rep=False)
    res = jax.jit(fn)(g)
    out["g"] = np.asarray(res["g"])
    out["b"] = np.asarray(res["b"])
    """)
    for key, rows in (("g", g), ("b", g[:, :5] * 3)):
        want = rows.mean(axis=0)
        scale = np.abs(rows).max() / 127.0
        assert np.abs(got[key] - want).max() <= scale * 1.5 + 1e-7, key
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-9, err_msg=key)
