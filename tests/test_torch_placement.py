"""repro_torch's tile placement and batched bucket routing against the
reference's, in this process on the CPU (no mesh is needed for either).

Placements are pure arrangement: the port's arrays must equal the
reference's exactly on the same NumPy-seeded inputs
(``tests/test_routing.py``'s placement cases mirrored).  Batched routing
must give the reference's bucket orders for every ``route_dtype``, and
each row of ``route_batch`` must equal that query's ``route`` bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layout import build_flat_store as j_build_flat_store
from repro.core.layout import device_mirror as j_device_mirror
from repro.data.synthetic import make_dataset
from repro.dist.placement import Placement as JPlacement
from repro.dist.placement import assign_buckets as j_assign_buckets
from repro.index import ivf as jivf
from repro.index import kmeans as jk
from repro_torch.core.engine import VectorSearchEngine
from repro_torch.core.layout import PAD_VALUE, build_flat_store
from repro_torch.core.plan import _get_placement
from repro_torch.dist.placement import Placement, assign_buckets
from repro_torch.index import ivf as tivf
from repro_torch.obs import metrics


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_placement(pl, jpl):
    assert (pl.kind, pl.axis, pl.n_shards) == (jpl.kind, jpl.axis, jpl.n_shards)
    np.testing.assert_array_equal(pl.part_perm, jpl.part_perm)
    np.testing.assert_array_equal(_np(pl.data), _np(jpl.data))
    np.testing.assert_array_equal(_np(pl.ids), _np(jpl.ids))
    for f in ("bucket_shard", "slot_bucket", "bucket_parts"):
        a, b = getattr(pl, f), getattr(jpl, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)


def _ivf_engine(n, dim, nlist, seed):
    X, _ = make_dataset(n, dim, "clustered", n_queries=1, seed=seed)
    return VectorSearchEngine.build(X, index="ivf", pruner="linear", capacity=64,
                                    nlist=nlist, device="cpu")


# ---------------------------------------------------------------- placement
def test_assign_buckets_greedy_balance():
    """``tests/test_routing.py::test_assign_buckets_greedy_balance``: the LPT
    bound and the reference's assignment, trial for trial."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        parts = rng.integers(0, 12, size=rng.integers(1, 40))
        n = int(rng.integers(1, 9))
        shard = assign_buckets(parts, n)
        np.testing.assert_array_equal(shard, j_assign_buckets(parts, n))
        assert (0 <= shard).all() and (shard < n).all()
        load = np.bincount(shard, weights=parts, minlength=n)
        assert load.max() - load.min() <= max(int(parts.max(initial=0)), 1)


@pytest.mark.parametrize("n_shards", [3, 4])
def test_block_placement_matches_legacy_padding(n_shards):
    """``tests/test_routing.py::test_block_placement_matches_legacy_padding``:
    8 partitions over 3 ranks pad one empty tile; over 4 the store's own
    tensors are used, uncopied; the arrays equal the reference's, and
    ``local`` hands each rank its slice."""
    X, _ = make_dataset(500, 8, "normal", n_queries=1, seed=1)
    store = build_flat_store(X, capacity=64, device="cpu")
    pl = Placement.block(store.data, store.ids, n_shards)
    _same_placement(pl, JPlacement.block(j_build_flat_store(X, capacity=64).data,
                                         j_build_flat_store(X, capacity=64).ids,
                                         n_shards))
    if n_shards == 3:
        assert pl.num_slots == 9 and pl.parts_per_shard == 3
        assert (pl.data[8] == PAD_VALUE).all() and (pl.ids[8] == -1).all()
        assert pl.part_perm.tolist() == [0, 1, 2, 3, 4, 5, 6, 7, -1]
    else:
        assert pl.data is store.data and pl.ids is store.ids
    w = pl.parts_per_shard
    for r in range(n_shards):
        d, i = pl.local(r)
        assert d.data_ptr() == pl.data[r * w].data_ptr() and d.shape[0] == w
        assert torch.equal(i, pl.ids[r * w:(r + 1) * w])


@pytest.mark.parametrize("n_shards", [3, 4, 8])
def test_pad_partitions_to_shards_matches_the_reference(n_shards):
    """``pdx_sharded``'s public names are the reference's, in its order:
    ``pad_partitions_to_shards`` gives the reference's padded (data, ids)
    bit for bit, and ``collective_counts`` is the meter of ``obs.meters``."""
    from repro.dist import pdx_sharded as jsharded
    from repro_torch.dist import pdx_sharded
    from repro_torch.dist.pdx_sharded import collective_counts, pad_partitions_to_shards
    from repro_torch.obs import meters

    assert pdx_sharded.__all__ == jsharded.__all__
    assert collective_counts is meters.collective_counts
    X, _ = make_dataset(500, 8, "normal", n_queries=1, seed=1)
    store = build_flat_store(X, capacity=64, device="cpu")
    jstore = j_build_flat_store(X, capacity=64)
    data, ids = pad_partitions_to_shards(store.data, store.ids, n_shards)
    jdata, jids = jsharded.pad_partitions_to_shards(jstore.data, jstore.ids, n_shards)
    assert data.shape[0] % n_shards == 0 and data.dtype == torch.float32
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_bucket_placement_invariants():
    """``tests/test_routing.py::test_bucket_placement_invariants``, and the
    port's bucket placement equal to the reference's on the same store."""
    eng = _ivf_engine(1024, 16, 8, seed=2)
    pl = _get_placement(eng.store, 4, "bucket", ivf=eng.ivf)
    assert pl.kind == "bucket" and pl.num_slots % 4 == 0
    real = np.sort(pl.part_perm[pl.part_perm >= 0])
    np.testing.assert_array_equal(real, np.arange(eng.store.num_partitions))
    width = pl.parts_per_shard
    for i in range(pl.num_slots):
        b = pl.slot_bucket[i]
        if b >= 0:
            assert pl.bucket_shard[b] == i // width
    src = eng.store.data.numpy()
    for i, p in enumerate(pl.part_perm):
        if p >= 0:
            np.testing.assert_array_equal(pl.data[i].numpy(), src[p])
    pl.check()
    pb = np.repeat(np.arange(eng.ivf.nlist), eng.ivf.part_counts)
    jpl = JPlacement.bucket(jnp.asarray(src), jnp.asarray(eng.store.ids.numpy()),
                            pb, eng.ivf.nlist, 4)
    _same_placement(pl, jpl)
    # a mirror rides the same arrangement, pad slots zero
    m = np.arange(src.size, dtype=np.float32).reshape(src.shape)
    np.testing.assert_array_equal(pl.arrange(torch.from_numpy(m)).numpy(),
                                  np.asarray(jpl.arrange(jnp.asarray(m))))


def test_placement_check_rejects_corruption():
    """``tests/test_routing.py::test_placement_check_rejects_corruption``."""
    eng = _ivf_engine(256, 8, 4, seed=3)
    pl = _get_placement(eng.store, 2, "bucket", ivf=eng.ivf)
    dup = pl.part_perm.copy()
    dup[-1] = dup[0]
    with pytest.raises(ValueError, match="more than once"):
        dataclasses.replace(pl, part_perm=dup).check()
    flipped = (pl.bucket_shard + 1) % 2
    with pytest.raises(ValueError, match="span shard slices"):
        dataclasses.replace(pl, bucket_shard=flipped).check()


def test_placement_cache_no_thrash_across_mesh_sizes():
    """``tests/test_routing.py::test_placement_cache_no_thrash_across_mesh_sizes``:
    one entry per (tiles_version, n_shards, kind), kept across head-only
    inserts, evicted by a compaction; hits and misses counted under
    ``repro_cache_events_total{cache="placement"}``."""
    X, _ = make_dataset(600, 8, "normal", n_queries=1, seed=4)
    eng = VectorSearchEngine.build(X, index="ivf", pruner="linear", capacity=64,
                                   nlist=4, device="cpu")
    eng.insert(np.zeros((1, 8), np.float32))  # upgrade to mutable
    store = eng.store
    reg = metrics.get_registry()
    reg.reset()
    metrics.set_enabled(True)
    try:
        a2 = _get_placement(store, 2, "block")
        a4 = _get_placement(store, 4, "block")
        b2 = _get_placement(store, 2, "bucket", ivf=eng.ivf)
        assert _get_placement(store, 2, "block") is a2
        assert _get_placement(store, 4, "block") is a4
        assert _get_placement(store, 2, "bucket", ivf=eng.ivf) is b2
        eng.insert(np.ones((1, 8), np.float32))
        assert _get_placement(store, 2, "block") is a2
        events = reg.snapshot()["counters"]["repro_cache_events_total"]
    finally:
        metrics.set_enabled(False)
        reg.reset()
    assert sorted(v for k, v in events.items() if "placement" in k) == [3.0, 4.0]
    eng.compact()
    a2b = _get_placement(store, 2, "block")
    assert a2b is not a2
    assert all(k[0] == store.tiles_version for k in store._placement_cache)


# ---------------------------------------------------------- batched routing
@pytest.fixture(scope="module")
def routed_pair():
    X, Q = make_dataset(900, 12, "clustered", n_queries=16, seed=8)
    pre = jk.kmeans(X, 10, iters=5, seed=0)
    ji = jivf.build_ivf(X, 10, capacity=64, precomputed=pre)
    ti = tivf.build_ivf(X, 10, capacity=64, precomputed=pre, device="cpu")
    return ti, ji, Q


@pytest.mark.parametrize("B", [1, 7, 16])
@pytest.mark.parametrize("route_dtype", ["f32", "bf16", "int8", "int4"])
def test_route_batch_equals_route_and_the_reference(routed_pair, route_dtype, B):
    """The batched ranking's orders equal the reference's
    ``_rank_centroids_batch`` (f32) and ``_rank_centroids_batch_mirror``
    (reduced dtypes) at B = 1, 7 and 16, and each row of ``route_batch``
    equals that query's ``route`` order bit for bit."""
    ti, ji, Q = routed_pair
    Qb = Q[:B]
    got = ti._ranked_batch(torch.from_numpy(Qb), "l2", route_dtype).numpy()
    if route_dtype == "f32":
        want = jivf._rank_centroids_batch(ji.centroid_store.data, jnp.asarray(Qb),
                                          ji.nlist, "l2")
    else:
        m = j_device_mirror(ji.centroid_store, route_dtype)
        want = jivf._rank_centroids_batch_mirror(
            m.data, jnp.asarray(Qb), ji.nlist, "l2",
            m.scale if m.quantized else None, m.offset if m.quantized else None,
            m.packed, m.dim)
    np.testing.assert_array_equal(got, np.asarray(want))
    sel = ti.route_batch(torch.from_numpy(Qb), ji.nlist, "l2", route_dtype)
    for b in range(B):
        np.testing.assert_array_equal(
            sel[b], ti.rank_buckets(torch.from_numpy(Qb[b]), "l2", route_dtype))


def test_batched_ranking_pads_to_a_fixed_chunk(monkeypatch):
    """The ranking chunk is set by the centroid tiles, never by the batch:
    every reduction sees (Bc, Pc, D, C) whatever B is, so a query is
    ranked on the same shape alone (``route``) as inside a batch."""
    shapes = []
    real_sum = torch.sum

    def spy(t, *a, **kw):
        shapes.append(tuple(t.shape))
        return real_sum(t, *a, **kw)

    cdata = torch.randn(2, 12, 64)
    bc = tivf._route_chunk(cdata)
    monkeypatch.setattr(tivf.torch, "sum", spy)
    for B in (1, 3, bc + 1):
        tivf._rank_centroids_batch(cdata, torch.randn(B, 12), 100, "l2")
    assert set(shapes) == {(bc, 2, 12, 64)}


def test_off_f32_routing_dequantizes_once_per_mirror_version(routed_pair, monkeypatch):
    """Off f32 the centroid mirror is dequantized once per mirror (dtype and
    ``tiles_version``), not once per call: repeated routes reuse it, and a
    rebuilt centroid store (a new mirror) dequantizes again."""
    ti, _, Q = routed_pair
    calls = []
    real = tivf.dequantize_ref

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tivf, "dequantize_ref", counting)
    ti._route_f32.clear()
    for _ in range(3):
        ti.route_batch(torch.from_numpy(Q), 4, "l2", "int8")
        ti.route(torch.from_numpy(Q[0]), 4, "l2", "int8")
    assert len(calls) == 1
    ti.route_batch(torch.from_numpy(Q), 4, "l2", "int4")
    assert len(calls) == 2
    ti.route_batch(torch.from_numpy(Q), 4, "l2", "int8")
    assert len(calls) == 2
    old = ti.centroid_store
    try:
        ti.centroid_store = build_flat_store(ti.centroids.numpy(),
                                             capacity=old.capacity, device="cpu")
        ti.route_batch(torch.from_numpy(Q), 4, "l2", "int8")
        assert len(calls) == 3
    finally:
        ti.centroid_store = old
        ti._route_f32.clear()
