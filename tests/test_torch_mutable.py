"""repro_torch's mutable store against the reference's, on the CPU.

Mirrors ``tests/test_mutable.py`` (all but the 8-device sharded test, which
waits for the port's multi-device search, and the reference's jit-cache
test, whose place a mirror-cache test takes) and the mutable property test
of ``tests/test_property.py``, and adds port-against-reference cases: the
same churn applied to both packages, and one churned reference state
carried into the port (``convert.mutable_store_arrays`` /
``mutable_store_from_arrays``).

Two oracles, as in the reference: a store REBUILT from the survivors and
searched with the same executor (ids mapped through ``searchsorted`` over
the sorted live ids, since mutable ids are sparse), and the reference
itself on identical state.  Tolerances: ids equal (near-tie swaps allowed
where the test says so, as in ``tests/test_torch_engine.py``); distances
allclose at rtol 1e-5 / atol 1e-5 against a rebuilt port store, and at
rtol 1e-4 / atol 1e-3 against the reference.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import SearchSpec as JSpec
from repro.core.engine import VectorSearchEngine as JEngine
from repro.core.layout import MutablePDXStore as JMutable
from repro.core.layout import build_flat_store as j_build_flat_store
from repro.core.layout import pdx_to_nary as j_pdx_to_nary
from repro.core.pruners import pca_components
from repro.data.synthetic import ground_truth, make_dataset, recall_at_k
from repro_torch.convert import (
    engine_from_arrays,
    mutable_store_arrays,
    mutable_store_from_arrays,
)
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.core.layout import (
    PAD_VALUE,
    MutablePDXStore,
    build_bucketed_store,
    build_flat_store,
    device_mirror,
    pdx_to_nary,
    projection_mirror,
)
from repro_torch.core.pdxearch import SearchStats

from test_torch_engine import assert_same_results, ref_arrays

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover
    from minihyp import given, settings
    from minihyp import strategies as st

CPU = dict(device="cpu")


class Oracle:
    """Shadow dict of live id -> vector, mirroring engine mutations."""

    def __init__(self, X):
        self.rows = {i: np.asarray(X[i]) for i in range(len(X))}

    def insert(self, eng, V):
        ids = eng.insert(V)
        for r, i in enumerate(ids):
            self.rows[int(i)] = np.asarray(V[r])
        return ids

    def delete(self, eng, ids):
        removed = eng.delete(ids)
        for i in np.atleast_1d(ids):
            self.rows.pop(int(i), None)
        return removed

    @property
    def live_ids(self):
        return np.asarray(sorted(self.rows))

    @property
    def surviving(self):
        return np.stack([self.rows[i] for i in sorted(self.rows)])


def _assert_matches_rebuilt(eng, oracle, Q, spec, executors, **build_kw):
    ref = VectorSearchEngine.build(oracle.surviving, **CPU, **build_kw)
    im = oracle.live_ids
    for ex in executors:
        got = eng.search(Q, spec.replace(executor=ex))
        want = ref.search(Q, spec.replace(executor=ex))
        assert got.plan.executor == ex
        np.testing.assert_array_equal(
            np.searchsorted(im, got.ids), want.ids, err_msg=ex
        )
        np.testing.assert_allclose(
            got.dists, want.dists, rtol=1e-5, atol=1e-5, err_msg=ex
        )


def _churn(engines, oracle, rng, rounds=3, ins=15, dels=10):
    """The same inserts and deletes on every engine of ``engines`` (ids
    must agree); ``oracle`` follows the first."""
    for _ in range(rounds):
        V = rng.standard_normal((ins, engines[0].dim)).astype(np.float32)
        ids = oracle.insert(engines[0], V)
        for e in engines[1:]:
            np.testing.assert_array_equal(e.insert(V), ids)
        victims = rng.choice(oracle.live_ids, size=dels, replace=False)
        removed = oracle.delete(engines[0], victims)
        for e in engines[1:]:
            assert e.delete(victims) == removed


# ------------------------------------------------------------- store invariants
def test_roundtrip_under_interleaved_mutation(rng):
    X = rng.standard_normal((300, 16)).astype(np.float32)
    store = MutablePDXStore.from_store(
        build_flat_store(X, capacity=64, **CPU), head_capacity=32
    )
    jstore = JMutable.from_store(j_build_flat_store(X, capacity=64),
                                 head_capacity=32)
    rows = {i: X[i] for i in range(300)}
    v0 = store.version

    new = rng.standard_normal((20, 16)).astype(np.float32)
    ids = store.insert(new)
    np.testing.assert_array_equal(jstore.insert(new), ids)
    assert ids.tolist() == list(range(300, 320))
    for r, i in enumerate(ids):
        rows[int(i)] = new[r]
    assert store.delete([0, 5, 299, 305, 9999]) == 4  # 9999 never existed
    assert jstore.delete([0, 5, 299, 305, 9999]) == 4
    for i in (0, 5, 299, 305):
        rows.pop(i)

    expected = np.stack([rows[i] for i in sorted(rows)])
    np.testing.assert_array_equal(pdx_to_nary(store), expected)
    assert store.num_vectors == len(rows)
    assert store.version > v0

    # interleave more mutations with repacks
    store.repack()
    jstore.repack()
    assert store.head_count == 0
    np.testing.assert_array_equal(pdx_to_nary(store), expected)

    more = rng.standard_normal((50, 16)).astype(np.float32)
    ids2 = store.insert(more)  # 50 > head_capacity=32: forces a mid-insert flush
    jstore.insert(more)
    for r, i in enumerate(ids2):
        rows[int(i)] = more[r]
    store.delete(ids2[:10])
    jstore.delete(ids2[:10])
    for i in ids2[:10]:
        rows.pop(int(i))
    expected = np.stack([rows[i] for i in sorted(rows)])
    np.testing.assert_array_equal(pdx_to_nary(store), expected)
    # the reference's store holds the same tiles, ids and versions
    np.testing.assert_array_equal(store.data.numpy(), np.asarray(jstore.data))
    np.testing.assert_array_equal(store.ids.numpy(), np.asarray(jstore.ids))
    assert (store.version, store.tiles_version) == (
        jstore.version, jstore.tiles_version)
    store.repack()
    np.testing.assert_array_equal(pdx_to_nary(store), expected)


def test_tombstoned_slots_are_poisoned_and_reusable(rng):
    X = rng.standard_normal((128, 8)).astype(np.float32)
    store = MutablePDXStore.from_store(
        build_flat_store(X, capacity=64, **CPU), head_capacity=16
    )
    assert store.delete([3, 17]) == 2
    data = store.data.numpy()
    ids = store.ids.numpy()
    assert (ids[0, 3] == -1) and (ids[0, 17] == -1)
    assert (data[0, :, 3] == PAD_VALUE).all()
    assert (data[0, :, 17] == PAD_VALUE).all()

    # flush drains the write-head into exactly those freed slots: the store
    # is full otherwise, so partition count must NOT grow
    P0 = store.num_partitions
    store.insert(rng.standard_normal((2, 8)).astype(np.float32))
    store.flush()
    assert store.head_count == 0
    assert store.num_partitions == P0
    ids = store.ids.numpy()
    assert {int(ids[0, 3]), int(ids[0, 17])} == {128, 129}


def test_write_head_absorbs_until_flush(rng):
    X = rng.standard_normal((100, 8)).astype(np.float32)
    store = MutablePDXStore.from_store(
        build_flat_store(X, capacity=64, **CPU), head_capacity=8
    )
    store.insert(rng.standard_normal((5, 8)).astype(np.float32))
    assert store.head_count == 5
    hids, hvecs = store.head_live()
    assert hids.tolist() == [100, 101, 102, 103, 104]
    assert hvecs.shape == (5, 8)
    # 4 more overflow the 8-slot head mid-insert -> automatic flush
    store.insert(rng.standard_normal((4, 8)).astype(np.float32))
    assert store.head_count < 9
    assert store.num_vectors == 109


def test_version_is_monotone_and_recorded_in_plan():
    X, Q = make_dataset(400, 16, "normal", n_queries=1, seed=3)
    eng = VectorSearchEngine.build(X, pruner="linear", capacity=128, **CPU)
    jeng = JEngine.build(X, pruner="linear", capacity=128)
    res = eng.search(Q[0], SearchSpec(k=3))
    assert res.plan.store_version == 0  # frozen store

    versions = [0]
    for e in (eng, jeng):
        e.insert(np.zeros((1, 16), np.float32))
    versions.append(eng.store.version)
    for e in (eng, jeng):
        e.delete([0])
    versions.append(eng.store.version)
    for e in (eng, jeng):
        e.compact()
    versions.append(eng.store.version)
    assert versions == sorted(set(versions)), versions  # strictly increasing
    res = eng.search(Q[0], SearchSpec(k=3))
    assert res.plan.store_version == eng.store.version > 0
    want = jeng.search(Q[0], JSpec(k=3))
    assert res.plan.store_version == want.plan.store_version
    assert eng.store.tiles_version == jeng.store.tiles_version


# ----------------------------------------------------------------- cache safety
def test_mirrors_key_on_tiles_version_and_evict_stale():
    """The device and projection mirrors key on ``tiles_version``: a
    head-only insert reuses them, a sealed mutation rebuilds them, and the
    upload of a new version drops every entry of an older one."""
    X, _ = make_dataset(600, 16, "normal", n_queries=1, seed=4)
    eng = VectorSearchEngine.build(X, pruner="linear", capacity=64, **CPU)
    frozen = eng.store
    device_mirror(frozen, "int8")
    projection_mirror(frozen, 4, "int8")
    assert frozen._mirror_cache and frozen._proj_cache

    eng.insert(np.ones((1, 16), np.float32))
    store = eng.store
    assert isinstance(store, MutablePDXStore)
    # the frozen store's mirrors were dropped with the upgrade
    assert not frozen._mirror_cache and not frozen._proj_cache
    m0 = device_mirror(store, "int8")
    p0 = projection_mirror(store, 4, "int8")
    data0 = store.data

    eng.insert(np.full((3, 16), 2.0, np.float32))  # head-only
    assert store.tiles_version == 0
    assert device_mirror(store, "int8") is m0
    assert projection_mirror(store, 4, "int8") is p0
    assert store.data is data0  # no re-upload

    eng.delete([5])  # a sealed slot: the tiles change
    assert store.tiles_version == 1
    data1 = store.data
    assert data1 is not data0
    # the upload evicted every version-0 mirror and projection entry
    assert all(k[-1] == 1 for k in store._mirror_cache)
    assert all(k[-1] == 1 for k in store._proj_cache)
    m1 = device_mirror(store, "int8")
    assert m1 is not m0 and m1.tiles_version == 1
    assert projection_mirror(store, 4, "int8").tiles_version == 1
    assert int((m1.data.shape[0])) == store.num_partitions
    assert set(store._mirror_cache) == {("int8", 1)}
    assert {k for k in store._proj_cache if k[0] != "comps"} == {(4, "int8", 1)}


def test_from_store_takes_the_frozen_store_device_and_masters(rng):
    X = rng.standard_normal((200, 8)).astype(np.float32)
    frozen = build_flat_store(X, capacity=64, **CPU)
    store = MutablePDXStore.from_store(frozen, head_capacity=4)
    assert store.device == frozen.device
    store.delete([0])
    # the masters are copies: the frozen store's tiles are untouched
    assert int(frozen.ids[0, 0]) == 0
    np.testing.assert_array_equal(frozen.data[0, :, 0].numpy(), X[0])


# ------------------------------------------------------- parity under churn
@pytest.mark.parametrize("pruner", ["linear", "bond"])
def test_host_executor_parity_under_churn_flat(pruner):
    rng = np.random.default_rng(11)
    X, Q = make_dataset(1024, 24, "normal", n_queries=3, seed=11)
    build_kw = dict(pruner=pruner, capacity=128)
    eng = VectorSearchEngine.build(X, **CPU, **build_kw)
    eng.head_capacity = 32
    oracle = Oracle(X)
    spec = SearchSpec(k=5)
    executors = ("adaptive", "jit-masked", "batch-matmul")

    _churn([eng], oracle, rng)
    assert eng.store.head_count > 0  # write-head populated: merged exactly
    _assert_matches_rebuilt(eng, oracle, Q, spec, executors, **build_kw)

    eng.compact()
    assert eng.store.head_count == 0
    _assert_matches_rebuilt(eng, oracle, Q, spec, executors, **build_kw)


def test_adaptive_ivf_parity_under_churn():
    rng = np.random.default_rng(12)
    X, Q = make_dataset(1536, 24, "clustered", n_queries=3, seed=12)
    nlist = 8
    build_kw = dict(index="ivf", pruner="linear", capacity=128, nlist=nlist)
    eng = VectorSearchEngine.build(X, **CPU, **build_kw)
    eng.head_capacity = 16  # small head: churn forces bucket-local flushes
    oracle = Oracle(X)
    spec = SearchSpec(k=5, nprobe=nlist)  # full probe -> exact

    _churn([eng], oracle, rng, rounds=4, ins=20, dels=15)
    im = oracle.live_ids
    ref = VectorSearchEngine.build(oracle.surviving, **CPU, **build_kw)
    got = eng.search(Q, spec)
    want = ref.search(Q, spec)
    assert got.plan.executor == "adaptive"
    np.testing.assert_array_equal(np.searchsorted(im, got.ids), want.ids)

    eng.compact()
    # bucket structure stays consistent after repack
    assert eng.ivf.part_counts.sum() == eng.store.num_partitions
    assert (eng.ivf.part_offsets == eng.store.part_offsets).all()
    got = eng.search(Q, spec)
    np.testing.assert_array_equal(np.searchsorted(im, got.ids), want.ids)
    # exact full scan agrees too
    got = eng.search(Q, spec.replace(executor="batch-matmul"))
    want = ref.search(Q, spec.replace(executor="batch-matmul"))
    np.testing.assert_array_equal(np.searchsorted(im, got.ids), want.ids)


# every single-device executor the mutable engines run on the CPU: the
# fused executors at a full and a reduced width, and the cascade
PARITY_SPECS = [
    ("adaptive", {}), ("jit-masked", {}), ("batch-matmul", {}),
    ("fused-scan", dict(scan_dtype="f32")), ("fused-scan", dict(scan_dtype="int8")),
    ("fused-batch", dict(scan_dtype="f32")), ("fused-batch", dict(scan_dtype="int8")),
    ("cascade-scan", dict(cascade=("proj8:int8", "int4", "f32"))),
    ("cascade-batch", dict(cascade=("bf16", "int8", "f32"))),
]


def _ref_kernel(executor):
    return "pallas" if executor.startswith(("fused", "cascade")) else "jnp"


def _assert_matches_reference(te, je, Q, nprobe, ivf):
    for ex, kw in PARITY_SPECS:
        if ivf and ex == "jit-masked":
            continue
        q = Q[0] if ex in ("fused-scan", "cascade-scan") else Q
        want = je.search(q, JSpec(k=5, nprobe=nprobe, executor=ex,
                                  kernel=_ref_kernel(ex), **kw))
        got = te.search(q, SearchSpec(k=5, nprobe=nprobe, executor=ex, **kw))
        assert got.plan.store_version == want.plan.store_version
        assert_same_results(want.ids, want.dists, got.ids, got.dists)


@pytest.mark.parametrize("pruner", ["adsampling", "bond", "bsa"])
@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_churn_and_compact_match_reference(pruner, index):
    """The same churn on a reference engine and on the port engine carried
    over from it returns the reference's ids through every executor, with
    live write-head rows and tombstones mid-partition, and again after
    ``compact`` (BOND rebuilt, BSA recalibrated)."""
    X, Q = make_dataset(1200, 24, "clustered", n_queries=3, seed=21)
    kw = dict(pruner=pruner, capacity=128)
    if index == "ivf":
        kw.update(index="ivf", nlist=6)
    je = JEngine.build(X, **kw)
    arrays = ref_arrays(je)
    if pruner == "bsa":
        comps, eig = pca_components(X)  # the build's sample: every row
        arrays.update(components=comps, eigval=eig, bsa_m=3.0)
    te = engine_from_arrays(arrays, **CPU)
    je.head_capacity = te.head_capacity = 16
    rng = np.random.default_rng(21)
    _churn([je, te], Oracle(X), rng, rounds=3, ins=20, dels=25)
    assert te.store.head_count > 0
    assert (te.store.ids.numpy() < 0).any()
    np.testing.assert_array_equal(te.store.ids.numpy(), np.asarray(je.store.ids))
    _assert_matches_reference(te, je, Q, 3, index == "ivf")

    je.compact()
    te.compact()
    assert te.pruner.name == je.pruner.name
    if index == "ivf":
        np.testing.assert_array_equal(te.ivf.part_offsets, je.ivf.part_offsets)
        np.testing.assert_array_equal(te.ivf.part_counts, je.ivf.part_counts)
    np.testing.assert_allclose(pdx_to_nary(te.store), j_pdx_to_nary(je.store),
                               rtol=1e-5, atol=1e-5)
    _assert_matches_reference(te, je, Q, 3, index == "ivf")


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_churned_reference_state_carries_across(index):
    """One churned reference state, carried into the port as NumPy arrays:
    every field equal, and the port answers with the reference's ids."""
    X, Q = make_dataset(900, 16, "clustered", n_queries=3, seed=22)
    kw = dict(pruner="adsampling", capacity=64)
    if index == "ivf":
        kw.update(index="ivf", nlist=5)
    je = JEngine.build(X, **kw)
    je.head_capacity = 24
    oracle = Oracle(X)
    _churn([je], oracle, np.random.default_rng(22), rounds=4, ins=17, dels=30)
    assert je.store.head_count > 0
    arrays = {**ref_arrays(je), **mutable_store_arrays(je.store)}
    te = engine_from_arrays(arrays, **CPU)
    assert isinstance(te.store, MutablePDXStore)
    for k, v in mutable_store_arrays(te.store).items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    assert te.store._id_loc == je.store._id_loc
    if index == "ivf":
        np.testing.assert_array_equal(te.ivf.part_offsets, je.ivf.part_offsets)
    _assert_matches_reference(te, je, Q, 5, index == "ivf")
    # both go on mutating alike from the carried state
    V = np.random.default_rng(0).standard_normal((30, 16)).astype(np.float32)
    np.testing.assert_array_equal(te.insert(V), je.insert(V))
    te.compact()
    je.compact()
    np.testing.assert_array_equal(te.store.ids.numpy(), np.asarray(je.store.ids))
    _assert_matches_reference(te, je, Q, 5, index == "ivf")


def test_store_from_arrays_round_trips():
    X, _ = make_dataset(300, 8, "normal", n_queries=1, seed=5)
    eng = VectorSearchEngine.build(X, pruner="linear", capacity=64, **CPU)
    eng.head_capacity = 8
    _churn([eng], Oracle(X), np.random.default_rng(5), rounds=2, ins=11, dels=9)
    back = mutable_store_from_arrays(mutable_store_arrays(eng.store), **CPU)
    np.testing.assert_array_equal(pdx_to_nary(back), pdx_to_nary(eng.store))
    assert back._id_loc == eng.store._id_loc
    assert (back.version, back.tiles_version) == (
        eng.store.version, eng.store.tiles_version)


def test_merge_keeps_the_reference_tie_order():
    """Write-head rows that tie sealed rows exactly (duplicates) follow
    them, as the stable sort over [sealed | head] orders them; a k above
    the live count fills with +inf ties in the reference's order."""
    base, _ = make_dataset(20, 8, "normal", n_queries=1, seed=6)
    X = np.repeat(base, 3, axis=0)
    je = JEngine.build(X, pruner="linear", capacity=16)
    te = VectorSearchEngine.build(X, pruner="linear", capacity=16, **CPU)
    for e in (je, te):
        e.insert(base[[2, 2, 7]])
        e.delete([0, 1, 2, 3, 4, 5])
    Q = base[[2, 7]]
    for ex in ("batch-matmul", "adaptive", "fused-batch"):
        want = je.search(Q, JSpec(k=6, executor=ex, kernel=_ref_kernel(ex)))
        got = te.search(Q, SearchSpec(k=6, executor=ex))
        np.testing.assert_array_equal(got.ids, want.ids, err_msg=ex)
        # the matmul form rounds the sealed distances its own way
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-5,
                                   err_msg=ex)
    assert te.search(Q[0], SearchSpec(k=3, executor="adaptive")).ids.tolist() == [
        6, 7, 8]
    # more neighbours asked for than live rows: +inf ties, -1 ids
    small = np.repeat(base[:2], 2, axis=0)
    je = JEngine.build(small, pruner="linear", capacity=16)
    te = VectorSearchEngine.build(small, pruner="linear", capacity=16, **CPU)
    for e in (je, te):
        e.insert(base[[1]])
        e.delete([0])
    want = je.search(base[1], JSpec(k=8, executor="batch-matmul"))
    got = te.search(base[1], SearchSpec(k=8, executor="batch-matmul"))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-5)
    assert np.isinf(got.dists[4:]).all() and (got.ids[4:] == -1).all()  # 4 live


def test_clone_adopt_and_oplog_replay_match_reference():
    X, _ = make_dataset(256, 8, "normal", n_queries=1, seed=7)
    stores = [
        MutablePDXStore.from_store(build_flat_store(X, capacity=32, **CPU),
                                   head_capacity=8),
        JMutable.from_store(j_build_flat_store(X, capacity=32), head_capacity=8),
    ]
    rng = np.random.default_rng(7)
    V = rng.standard_normal((12, 8)).astype(np.float32)
    outs = []
    for s in stores:
        s.insert(V[:5])
        twin = s.clone()
        v = s.version
        s.oplog_start()
        s.insert(V[5:])
        s.delete([3, 4, 257])
        ops = s.oplog_take()
        twin.repack()
        assert twin.replay(ops) == 7 + 3
        assert not s.adopt(twin, expect_version=v)  # fence: s moved on
        assert s.adopt(twin, expect_version=s.version)
        outs.append((pdx_to_nary(s) if s is stores[0] else j_pdx_to_nary(s),
                     s.version, s.tiles_version, s.fragmentation))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]
    # an overflowing log reports None
    s = stores[0]
    s.oplog_start(limit=2)
    s.insert(V[:3])
    assert s.oplog_take() is None


# ----------------------------------------------------- batch-delete satellite
def test_batch_delete_10k_single_vectorized_pass(rng):
    """delete() resolves the whole id array to coordinates up front and
    poisons every slot in one pass — 10k deletes across sealed tiles AND
    the write-head in one call, with running moments, counts, and the id
    map staying exact."""
    X = rng.standard_normal((20000, 16)).astype(np.float32)
    store = MutablePDXStore.from_store(
        build_flat_store(X, capacity=256, **CPU), head_capacity=64
    )
    head = rng.standard_normal((50, 16)).astype(np.float32)
    store.insert(head)  # ids 20000..20049 live in the write-head
    rows = {i: X[i] for i in range(20000)}
    rows.update({20000 + r: head[r] for r in range(50)})

    victims = rng.choice(20050, size=10000, replace=False)
    # repeated + never-existing ids must not double-count
    removed = store.delete(np.concatenate([victims, victims[:7], [10**6]]))
    assert removed == 10000
    for i in victims:
        rows.pop(int(i))
    assert store.num_vectors == len(rows) == 10050
    expected = np.stack([rows[i] for i in sorted(rows)])
    np.testing.assert_array_equal(pdx_to_nary(store), expected)
    # tombstoned sealed slots are poisoned and re-usable
    ids_arr = store.ids.numpy()
    data_arr = store.data.numpy()
    assert (data_arr[:, 0, :][ids_arr < 0] == PAD_VALUE).all()
    assert int((ids_arr >= 0).sum()) == int(store._counts.sum())
    # moments stayed in sync -> a repack reproduces identical metadata
    before = store.dim_means.numpy().copy()
    store.repack()
    np.testing.assert_allclose(store.dim_means.numpy(), before, atol=1e-4)
    np.testing.assert_array_equal(pdx_to_nary(store), expected)


# ------------------------------------------------------ BSA-recal satellite
def test_bsa_recalibrated_on_compact():
    """compact() refits BSA's PCA from a fresh survivor sample and
    re-projects the live rows in place, so a churned-then-compacted engine
    prunes like one freshly built from the survivors."""
    rng = np.random.default_rng(31)
    X, Q = make_dataset(4096, 32, "clustered", n_queries=8, seed=31)
    build_kw = dict(pruner="bsa", capacity=128)
    eng = VectorSearchEngine.build(X, **CPU, **build_kw)
    fp0 = eng.pruner.fingerprint
    oracle = Oracle(X)
    # churn WITH distribution shift: the build-time PCA goes stale
    shifted = (rng.standard_normal((600, 32)) * 0.5 + 4.0).astype(np.float32)
    oracle.insert(eng, shifted)
    oracle.delete(eng, rng.choice(4096, size=1500, replace=False))

    eng.compact()
    assert eng.pruner.fingerprint != fp0  # recalibrated -> new identity

    fresh = VectorSearchEngine.build(oracle.surviving, **CPU, **build_kw)
    gt_ids, _ = ground_truth(oracle.surviving, Q, k=10)
    im = oracle.live_ids
    got = eng.search(Q, SearchSpec(k=10, executor="adaptive"))
    want = fresh.search(Q, SearchSpec(k=10, executor="adaptive"))
    r_got = recall_at_k(np.searchsorted(im, got.ids), gt_ids)
    r_fresh = recall_at_k(want.ids, gt_ids)
    assert abs(r_got - r_fresh) <= 0.02, (r_got, r_fresh)
    # pruning power matches the freshly calibrated pruner too
    s_got, s_fresh = SearchStats(), SearchStats()
    eng.search(Q[0], SearchSpec(k=10), stats=s_got)
    fresh.search(Q[0], SearchSpec(k=10), stats=s_fresh)
    assert abs(s_got.pruning_power - s_fresh.pruning_power) <= 0.05


def test_bsa_recal_keeps_ivf_centroids_consistent():
    """The recalibration rotates the stored coordinates; IVF centroids must
    rotate along (bucket membership is rotation-invariant), keeping
    full-probe search exact after compact."""
    rng = np.random.default_rng(32)
    X, Q = make_dataset(2048, 24, "clustered", n_queries=6, seed=32)
    eng = VectorSearchEngine.build(
        X, index="ivf", pruner="bsa", capacity=128, nlist=8, **CPU,
    )
    oracle = Oracle(X)
    oracle.insert(eng, rng.standard_normal((200, 24)).astype(np.float32))
    oracle.delete(eng, rng.choice(2048, size=400, replace=False))
    eng.compact()
    assert eng.ivf.part_counts.sum() == eng.store.num_partitions
    gt_ids, _ = ground_truth(oracle.surviving, Q, k=5)
    got = eng.search(Q, SearchSpec(k=5, nprobe=8))
    fresh = VectorSearchEngine.build(
        oracle.surviving, index="ivf", pruner="bsa", capacity=128, nlist=8,
        **CPU,
    )
    want = fresh.search(Q, SearchSpec(k=5, nprobe=8))
    r_got = recall_at_k(np.searchsorted(oracle.live_ids, got.ids), gt_ids)
    r_fresh = recall_at_k(want.ids, gt_ids)
    assert abs(r_got - r_fresh) <= 0.05, (r_got, r_fresh)


# ------------------------------------------------------- empty-bucket satellite
def test_empty_buckets_cost_zero_partitions(rng):
    X = rng.standard_normal((50, 4)).astype(np.float32)
    assign = np.zeros(50, dtype=np.int64)  # buckets 1, 2 empty
    store, offsets, nparts = build_bucketed_store(X, assign, 3, capacity=64,
                                                  **CPU)
    assert nparts.tolist() == [1, 0, 0]
    assert store.num_partitions == 1
    assert offsets.tolist() == [0, 1, 1]
    # scan work is zero for the empty buckets and search is still exact
    eng = VectorSearchEngine.build(
        X, index="ivf", pruner="linear", capacity=64, nlist=4,
        precomputed_ivf=(X[:4], np.zeros(50, dtype=np.int64)), **CPU,
    )
    assert eng.ivf.part_counts.tolist() == [1, 0, 0, 0]
    res = eng.search(X[7], SearchSpec(k=1, nprobe=4))
    assert res.ids[0] == 7


def test_route_skips_empty_buckets_for_start_phase(rng):
    X = rng.standard_normal((40, 4)).astype(np.float32)
    # everything in bucket 2; centroids placed so bucket 0 ranks nearest
    cents = np.stack([
        np.zeros(4, np.float32),
        np.ones(4, np.float32) * 50,
        np.ones(4, np.float32) * 100,
    ])
    assign = np.full(40, 2, dtype=np.int64)
    eng = VectorSearchEngine.build(
        X, index="ivf", pruner="linear", capacity=64, nlist=3,
        precomputed_ivf=(cents, assign), **CPU,
    )
    order, start_parts = eng.ivf.route(torch.zeros(4), nprobe=3)
    assert start_parts == 1  # bucket 2's single partition seeds START
    assert order.tolist() == [0]
    res = eng.search(X[3], SearchSpec(k=1, nprobe=3))
    assert res.ids[0] == 3
    # churn that empties the only bucket's partition and refills it through
    # the write-head keeps START on a non-empty bucket
    eng.head_capacity = 4
    eng.delete(np.arange(40))
    new = eng.insert(X[:6] + 0.25)
    eng.compact()
    assert eng.ivf.part_counts.sum() == eng.store.num_partitions
    res = eng.search(X[2] + 0.25, SearchSpec(k=1, nprobe=3))
    assert res.ids[0] == new[2]


# ------------------------------------------------------------- property test
_MUT_SETTINGS = settings(max_examples=10, deadline=None)


@_MUT_SETTINGS
@given(
    seed=st.integers(0, 2**31 - 1),
    ops=st.lists(st.sampled_from(["ins", "del", "repack"]), min_size=1,
                 max_size=8),
)
def test_mutable_store_always_matches_rebuilt_store(seed, ops):
    """After ANY interleaving of insert/delete/repack, search results equal a
    store rebuilt from scratch from the surviving vectors, and pdx_to_nary
    round-trips them (ids map via rank order since they are sparse)."""
    rng = np.random.default_rng(seed)
    dim, cap, k = 8, 32, 3
    X = rng.standard_normal((60, dim)).astype(np.float32)
    eng = VectorSearchEngine.build(X, pruner="linear", capacity=cap, **CPU)
    eng.head_capacity = 8  # tiny head: flushes + free-slot reuse get exercised
    rows = {i: X[i] for i in range(len(X))}

    for op in ops:
        if op == "ins":
            V = rng.standard_normal((int(rng.integers(1, 12)), dim)).astype(
                np.float32
            )
            for r, i in enumerate(eng.insert(V)):
                rows[int(i)] = V[r]
        elif op == "del" and len(rows) > k:
            victims = rng.choice(
                sorted(rows), size=int(rng.integers(1, 6)), replace=False
            )
            eng.delete(victims)
            for i in victims:
                rows.pop(int(i), None)
        elif op == "repack":
            eng.compact()

    assert isinstance(eng.store, MutablePDXStore)
    im = np.asarray(sorted(rows))
    Xs = np.stack([rows[i] for i in sorted(rows)])
    np.testing.assert_array_equal(pdx_to_nary(eng.store), Xs)
    assert eng.store.num_vectors == len(rows)

    ref = VectorSearchEngine.build(Xs, pruner="linear", capacity=cap, **CPU)
    q = rng.standard_normal(dim).astype(np.float32)
    for ex in ("adaptive", "jit-masked", "batch-matmul"):
        got = eng.search(q, SearchSpec(k=k, executor=ex))
        want = ref.search(q, SearchSpec(k=k, executor=ex))
        np.testing.assert_array_equal(
            np.searchsorted(im, got.ids), want.ids, err_msg=ex
        )
