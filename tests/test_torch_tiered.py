"""repro_torch's tiered serving and two-level IVF tree against the
reference's, on the CPU.

Mirrors the single-host tests of ``tests/test_tiered.py`` (the
``BucketCache``, the ``tiered-scan`` executor, the centroid tree and the
tiered meters; the 8-device ``routed_tiered`` test waits for the port's
multi-device search, and the oplog tests are mirrored in
``tests/test_torch_mutable.py``), and adds port-against-reference cases on
identical state: engines carried over from a reference engine
(``convert.engine_from_arrays``, the tree's arrays included), the
reference searched with ``kernel="jnp"``.

Tolerances: ids equal; distances at rtol 1e-5 (both packages re-rank the
same candidates against the same host masters in NumPy, so they come out
equal).  The cache's state (slot tables, stats, pool and id bytes) and the
host quantizers are held to the reference's bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine  # noqa: F401  (breaks the engine<->ivf import cycle)
from repro.core import layout as jl
from repro.core import plan as jplan
from repro.core.engine import SearchSpec as JSpec
from repro.core.engine import VectorSearchEngine as JEngine
from repro.core.pruners import pca_components
from repro.index import ivf as jivf
from repro.index import kmeans as jkmeans
from repro_torch.convert import engine_from_arrays
from repro_torch.core import layout as tl
from repro_torch.core import plan as tplan
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.core.layout import BucketCache, PDXStore, device_mirror
from repro_torch.core.pdxearch import SearchStats
from repro_torch.index import ivf as tivf
from repro_torch.index import kmeans as tkmeans
from repro_torch.obs import metrics as _metrics

from test_torch_engine import ref_arrays

CPU = dict(device="cpu")
DTYPES = ("f32", "bf16", "int8", "int4")
STAGING = ("worker", "device", "legacy")


def _clustered(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((k, d)).astype(np.float32) * 4
    X = (cents[rng.integers(0, k, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    Q = (cents[rng.integers(0, k, 16)]
         + rng.standard_normal((16, d)).astype(np.float32))
    return X.astype(np.float32), Q.astype(np.float32)


def _engine(n=4000, d=32, nlist=16, **kw):
    X, Q = _clustered(n, d, nlist)
    kw.setdefault("capacity", 64)  # ~4 partitions/bucket: room to evict
    eng = VectorSearchEngine.build(
        X, index="ivf", nlist=nlist, pruner="linear", **CPU, **kw
    )
    return eng, X, Q


def _recall(ids, ref_ids):
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    k = ids.shape[1]
    return np.mean([
        len(set(a.tolist()) & set(b.tolist())) / k
        for a, b in zip(ids, ref_ids)
    ])


def tree_arrays(ivf) -> dict:
    """A reference IVF's tree as NumPy arrays (the convert contract)."""
    if not ivf.tree_enabled:
        return {}
    return dict(super_centroids=np.asarray(ivf.super_centroids),
                super_children=np.asarray(ivf.super_children),
                nprobe_super=ivf.nprobe_super)


def _pair(X, **kw):
    """A reference engine and the port engine carried over from it."""
    je = JEngine.build(X, index="ivf", pruner="linear", **kw)
    te = engine_from_arrays({**ref_arrays(je), **tree_arrays(je.ivf)}, **CPU)
    return je, te


def _bytes(x) -> bytes:
    """The raw bytes of a reference array or a port tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.fixture(scope="module")
def pair():
    X, Q = _clustered(4000, 32, 16)
    je, te = _pair(X, nlist=16, capacity=64)
    return je, te, Q


# ------------------------------------------------- parity on identical state
@pytest.mark.parametrize("dtype,metric", [(dt, m) for dt in DTYPES for m in ("l2", "ip")]
                         + [("f32", "l1")])
def test_tiered_scan_matches_reference(pair, dtype, metric):
    """tiered-scan returns the reference's ids and distances at a pool that
    holds every routed bucket, at one that forces evictions and chunks, and
    at one smaller than a single bucket (multi-pass sub-extents)."""
    je, te, Q = pair
    cnts = np.asarray(je.ivf.part_counts)
    sel = te.ivf.route_batch(torch.from_numpy(Q), 4, metric)
    for slots in (64, int(np.sort(cnts)[-4:].sum()), 4):
        region = slots
        chunks = tplan._tiered_chunks(sel, cnts, lambda b: 0, region)
        passes = sum(len(tplan._chunk_passes(sel[c], cnts, lambda b: 0, region))
                     for c in chunks)
        kw = dict(k=10, nprobe=4, hbm_slots=slots, scan_dtype=dtype, metric=metric)
        want = je.search(Q, JSpec(kernel="jnp", **kw))
        got = te.search(Q, SearchSpec(**kw))
        assert got.plan.executor == want.plan.executor == "tiered-scan"
        np.testing.assert_array_equal(got.ids, want.ids, err_msg=f"slots={slots}")
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5)
        if slots == 4:
            assert passes > len(chunks) > 1  # chunks, each of several passes
    cache = te.store._tiered_cache[(4, dtype, 1)]
    jcache = je.store._tiered_cache[(4, dtype, 1)]
    np.testing.assert_array_equal(cache._slot_bucket, jcache._slot_bucket)
    np.testing.assert_array_equal(cache._slot_ids, jcache._slot_ids)


def test_tiered_stats_match_reference(pair):
    je, te, Q = pair
    from repro.core.pdxearch import SearchStats as JStats

    js, ts = JStats(), SearchStats()
    kw = dict(k=5, nprobe=3, hbm_slots=24, scan_dtype="int8")
    je.search(Q, JSpec(kernel="jnp", **kw), stats=js)
    te.search(Q, SearchSpec(**kw), stats=ts)
    for f in ("values_total", "values_computed", "values_avoided", "partitions_visited"):
        assert getattr(ts, f) == getattr(js, f), f


def test_tiered_schedules_match_reference(pair):
    """``_tiered_chunks`` and ``_chunk_passes`` give the reference's
    schedules on one routed set, over one and several regions."""
    je, te, Q = pair
    cnts = np.asarray(je.ivf.part_counts)
    sel = te.ivf.route_batch(torch.from_numpy(Q), 6)
    sel[3, 2:] = -1  # tree-style right pads
    for regions, region_slots in ((1, 4), (1, 9), (1, 30), (2, 5), (3, 12)):
        def region_of(b, n=regions):
            return b % n
        got = tplan._tiered_chunks(sel, cnts, region_of, region_slots)
        want = jplan._tiered_chunks(sel, cnts, region_of, region_slots)
        assert got == want
        for chunk in got:
            assert (tplan._chunk_passes(sel[chunk], cnts, region_of, region_slots)
                    == jplan._chunk_passes(sel[chunk], cnts, region_of, region_slots))


def test_merge_topk_rows_matches_reference():
    rng = np.random.default_rng(3)
    i1 = rng.integers(-1, 20, (6, 5))
    i2 = rng.integers(-1, 20, (6, 5))
    d1 = rng.integers(0, 6, (6, 5)).astype(np.float32)
    d2 = rng.integers(0, 6, (6, 5)).astype(np.float32)
    for got, want in zip(tplan._merge_topk_rows(i1, d1, i2, d2, 5),
                         jplan._merge_topk_rows(i1, d1, i2, d2, 5)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- cache state
def _stores(n=2000, d=16, nlist=8, seed=3, capacity=64):
    X, _ = _clustered(n, d, nlist, seed=seed)
    jivf_ = jivf.build_ivf(X, nlist, capacity=capacity)
    s = jivf_.store
    ts = PDXStore(*(torch.from_numpy(np.array(getattr(s, k)))
                    for k in ("data", "ids", "counts", "dim_means", "dim_vars")))
    return jivf_, ts


def _set_staging(bc, path):
    bc.stage_on_host = path == "worker"
    bc.sync_uploads = path == "legacy"


@pytest.mark.parametrize("path", STAGING)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cache_state_matches_reference(dtype, path):
    """One sequence of ``ensure``/``issue``/``wait`` leaves the port's cache
    in the reference's state: slot tables, LRU order, free lists, every
    call's stats, and the pool's and id table's bytes."""
    ji, ts = _stores()
    cap = int(np.asarray(ji.part_counts).max() * 3 + 1)
    kw = dict(capacity_slots=cap, dtype=dtype, part_offsets=ji.part_offsets,
              part_counts=ji.part_counts)
    jc, tc = jl.BucketCache(ji.store, **kw), BucketCache(ts, **kw)
    for bc in (jc, tc):
        _set_staging(bc, path)
    stats = []
    for bc in (jc, tc):
        seq = [bc.ensure(np.array([0, 1, 2]))]
        t1 = bc.issue(np.array([3, 1]))
        t2 = bc.issue(np.array([4]))           # depth-1: drains t1
        assert t1.done and not t2.done
        seq += [t1.stats, bc.wait(t2), bc.wait(t2)]
        seq.append(bc.ensure(np.array([5, 0, 6])))
        t3 = bc.issue(np.array([7, 2]))
        bc.arrays()                            # settles t3
        assert t3.done
        seq += [t3.stats, bc.ensure(np.array([2, 7, -1, 7]))]
        stats.append(seq)
    assert stats[0] == stats[1]
    assert any(s["evicted"] for s in stats[1])
    np.testing.assert_array_equal(tc._slot_bucket, jc._slot_bucket)
    np.testing.assert_array_equal(tc.slot_ids_host(), jc.slot_ids_host())
    assert [list(r.keys()) for r in tc._resident] == [list(r.keys()) for r in jc._resident]
    for a, b in zip(tc._resident[0].values(), jc._resident[0].values()):
        np.testing.assert_array_equal(a, b)
    assert tc._free == jc._free
    assert tc.resident_slots == jc.resident_slots
    tp, tids, tsb, tsc, toff = tc.arrays()
    jp, jids, jsb, jsc, joff = jc.arrays()
    assert _bytes(tp) == _bytes(jp)
    assert _bytes(tids) == _bytes(jids)
    np.testing.assert_array_equal(tsb.numpy(), np.asarray(jsb))
    assert _bytes(tsc) == _bytes(jsc) and _bytes(toff) == _bytes(joff)


@pytest.mark.parametrize("dtype", DTYPES)
def test_staging_paths_give_one_pool(dtype):
    """The three staging paths of the port (worker host-quantize, device
    quantize, blocking f32 upload) leave the same pool bit for bit."""
    ji, ts = _stores()
    cap = int(np.asarray(ji.part_counts).max() * 3 + 1)
    pools = []
    for path in STAGING:
        bc = BucketCache(ts, capacity_slots=cap, dtype=dtype,
                         part_offsets=ji.part_offsets, part_counts=ji.part_counts)
        _set_staging(bc, path)
        bc.ensure(np.array([0, 1, 2]))
        bc.wait(bc.issue(np.array([3])))
        pools.append(_bytes(bc.arrays()[0]))
    assert pools[0] == pools[1] == pools[2]


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_quant_matches_reference_bitwise_at_odd_dim(dtype):
    """``_host_quant_params`` and ``_host_quantize`` equal the reference's
    bit for bit at odd D (int4 pads a nibble), and ``_device_quantize``
    equals ``_host_quantize``."""
    X, _ = _clustered(3000, 17, 8, seed=5)
    ji = jivf.build_ivf(X, 8, capacity=64)
    data, ids = np.asarray(ji.store.data), np.asarray(ji.store.ids)
    means = np.asarray(ji.store.dim_means, np.float32)
    got = tl._host_quant_params(data, ids, means, dtype)
    want = jl._host_quant_params(data, ids, means, dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    ts = PDXStore(*(torch.from_numpy(np.array(getattr(ji.store, k)))
                    for k in ("data", "ids", "counts", "dim_means", "dim_vars")))
    tc = BucketCache(ts, capacity_slots=32, dtype=dtype,
                     part_offsets=ji.part_offsets, part_counts=ji.part_counts)
    jc = jl.BucketCache(ji.store, capacity_slots=32, dtype=dtype,
                        part_offsets=ji.part_offsets, part_counts=ji.part_counts)
    tc._revalidate()
    jc._revalidate()
    ext = np.array(data[:7], np.float32)
    host = tc._host_quantize(ext)
    assert _bytes(host) == _bytes(jc._host_quantize(ext))
    assert _bytes(tc._device_quantize(torch.from_numpy(ext))) == _bytes(host)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_cached_tiles_equal_the_resident_mirror(dtype):
    """In both packages a bucket's cached tiles equal the fully resident
    mirror's live lanes bit for bit (one quantization affine, the
    reference's rounding of its scale), so a cache at the store's size
    scans what ``fused-batch`` scans."""
    ji, ts = _stores(3000, 96, 8, seed=9)
    mirrors = (device_mirror(ts, dtype), jl.device_mirror(ji.store, dtype))
    assert _bytes(mirrors[0].scale) == _bytes(mirrors[1].scale)
    live = np.asarray(ji.store.ids) >= 0
    P = live.shape[0]
    for cls, store, m in ((BucketCache, ts, mirrors[0]), (jl.BucketCache, ji.store, mirrors[1])):
        bc = cls(store, capacity_slots=P, dtype=dtype,
                 part_offsets=ji.part_offsets, part_counts=ji.part_counts)
        bc.ensure(np.arange(8))
        pool = bc.arrays()[0]
        pool = pool.numpy() if isinstance(pool, torch.Tensor) else np.asarray(pool)
        mdata = m.data.numpy() if isinstance(m.data, torch.Tensor) else np.asarray(m.data)
        for b in range(8):
            off = int(ji.part_offsets[b])
            for j, s in enumerate(bc._resident[0][b]):
                lv = live[off + j]
                np.testing.assert_array_equal(pool[s][:, lv], mdata[off + j][:, lv])


def test_host_masters_are_pulled_once_per_version():
    """A frozen store's masters are copied to the host once per
    ``tiles_version`` and shared by every cache and the re-rank."""
    eng, X, Q = _engine(n=1500, nlist=8)
    store = eng.store
    eng.search(Q, SearchSpec(k=5, nprobe=3, hbm_slots=32))
    first = store._host_masters_cache
    eng.search(Q, SearchSpec(k=5, nprobe=3, hbm_slots=16, scan_dtype="int8"))
    assert store._host_masters_cache is first
    assert tl._host_masters(store)[0] is first[1]
    assert store._host_rows_cache[0] == first[0] == 0


# ------------------------------------------------------------ the tree
def test_centroid_tree_children_match_reference(monkeypatch):
    """``build_centroid_tree``'s greedy, balance-capped assignment gives
    the reference's child table when its inner k-means is handed the
    reference's super-centroids (the two k-means round differently)."""
    rng = np.random.default_rng(4)
    cents = rng.standard_normal((300, 12)).astype(np.float32)
    cents[:120] += 3.0  # a lopsided clustering, so the balance cap binds
    for super_k, balance in ((17, 1.5), (8, 1.0), (40, 2.0)):
        sc_ref, ch_ref = jkmeans.build_centroid_tree(cents, super_k, seed=2,
                                                     balance=balance)
        monkeypatch.setattr(tkmeans, "kmeans", lambda *a, sc=sc_ref, **k: (sc, None))
        sc, ch = tkmeans.build_centroid_tree(cents, super_k, seed=2, balance=balance,
                                             device="cpu")
        np.testing.assert_array_equal(sc, sc_ref)
        np.testing.assert_array_equal(ch, ch_ref)
        assert ch.max(initial=-1) < 300 and sorted(ch[ch >= 0].tolist()) == list(range(300))


def test_centroid_tree_on_its_own_kmeans_is_close_to_reference():
    """Without the hand-over the port's tree comes from its own k-means:
    the super-centroids agree to float rounding and the child table
    equals the reference's on well-separated centroids."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((6, 16)).astype(np.float32) * 8
    cents = (base[np.arange(60) % 6] + rng.standard_normal((60, 16)) * 0.3).astype(np.float32)
    sc_ref, ch_ref = jkmeans.build_centroid_tree(cents, 6, seed=0)
    sc, ch = tkmeans.build_centroid_tree(cents, 6, seed=0, device="cpu")
    np.testing.assert_allclose(sc, sc_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ch, ch_ref)


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
@pytest.mark.parametrize("super_k,nprobe_super", [(6, 2), (9, 4), (4, 4)])
def test_tree_routing_matches_reference(metric, super_k, nprobe_super):
    """Through the reference's tree arrays (``convert``), ``route_batch``,
    ``rank_buckets``, ``route`` and ``routing_cost`` equal the reference's,
    -1 pads included."""
    X, Q = _clustered(3000, 24, 30, seed=6)
    je, te = _pair(X, nlist=30, capacity=64, tree=True, super_k=super_k,
                   nprobe_super=nprobe_super)
    assert te.ivf.tree_enabled and te.ivf.routing_cost() == je.ivf.routing_cost()
    Qt = torch.from_numpy(Q)
    for nprobe in (3, 30):
        np.testing.assert_array_equal(te.ivf.route_batch(Qt, nprobe, metric),
                                      np.asarray(je.ivf.route_batch(Q, nprobe, metric)))
    np.testing.assert_array_equal(te.ivf.rank_buckets(Qt[0], metric),
                                  je.ivf.rank_buckets(Q[0], metric))
    for q in Q[:4]:
        to, ts_ = te.ivf.route(torch.from_numpy(q), 5, metric)
        jo, js_ = je.ivf.route(q, 5, metric)
        np.testing.assert_array_equal(to, jo)
        assert ts_ == js_


def test_tree_engine_search_matches_reference():
    """An engine carried over with its tree answers adaptive and
    tiered-scan searches with the reference's ids; ``IVFIndex.search``
    (the compatibility wrapper) too."""
    X, Q = _clustered(3000, 24, 30, seed=7)
    je, te = _pair(X, nlist=30, capacity=64, tree=True, super_k=6, nprobe_super=2)
    for kw in (dict(k=5, nprobe=4), dict(k=5, nprobe=4, hbm_slots=12, scan_dtype="int8")):
        want = je.search(Q, JSpec(kernel="jnp", **kw))
        got = te.search(Q, SearchSpec(**kw))
        assert got.plan.executor == want.plan.executor
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5)
    jr = je.ivf.search(Q[0], 5, je.pruner, nprobe=4)
    tr = te.ivf.search(torch.from_numpy(Q[0]), 5, te.pruner, nprobe=4)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    np.testing.assert_allclose(tr.dists.numpy(), np.asarray(jr.dists), rtol=1e-5)


def test_recalibrate_bsa_reclusters_the_tree_like_reference():
    """After inserts, deletes and ``compact`` a BSA engine with a tree
    re-projects its centroids and re-clusters the tree, as the reference
    does: the same fan-out and child table, super-centroids to float
    rounding, and the same routed buckets and ids."""
    X, Q = _clustered(2400, 24, 24, seed=8)
    je = JEngine.build(X, index="ivf", nlist=24, pruner="bsa", capacity=64,
                       tree=True, super_k=5, nprobe_super=2)
    comps, eig = pca_components(X)
    te = engine_from_arrays({**ref_arrays(je), **tree_arrays(je.ivf),
                             "components": comps, "eigval": eig, "bsa_m": 3.0}, **CPU)
    rng = np.random.default_rng(8)
    V = rng.standard_normal((40, 24)).astype(np.float32)
    np.testing.assert_array_equal(te.insert(V), je.insert(V))
    dead = rng.choice(2400, size=200, replace=False)
    assert te.delete(dead) == je.delete(dead)
    je.compact()
    te.compact()
    assert te.ivf.tree_enabled and te.ivf.nprobe_super == je.ivf.nprobe_super
    np.testing.assert_array_equal(te.ivf.super_children.numpy(),
                                  np.asarray(je.ivf.super_children))
    np.testing.assert_allclose(te.ivf.super_centroids.numpy(),
                               np.asarray(je.ivf.super_centroids), rtol=1e-4, atol=1e-4)
    Qt = te.pruner.transform_batch(torch.from_numpy(Q))
    jQt = jplan._transform_batch(je.pruner, jnp.asarray(Q))
    np.testing.assert_array_equal(te.ivf.route_batch(Qt, 4),
                                  np.asarray(je.ivf.route_batch(jQt, 4)))
    want = je.search(Q, JSpec(k=5, nprobe=4, kernel="jnp"))
    got = te.search(Q, SearchSpec(k=5, nprobe=4))
    np.testing.assert_array_equal(got.ids, want.ids)


# ------------------------------------------- mirrors of tests/test_tiered.py
def test_tiered_f32_bitwise_parity_with_routed():
    eng, X, Q = _engine()
    ref = eng.search(Q, SearchSpec(k=10, nprobe=4))
    res = eng.search(Q, SearchSpec(k=10, nprobe=4, hbm_slots=64))
    assert res.plan.executor == "tiered-scan"
    np.testing.assert_array_equal(res.ids, ref.ids)
    np.testing.assert_allclose(res.dists, ref.dists, rtol=1e-5)


def test_tiered_eviction_readmission_parity_small_capacity():
    """A cache far smaller than the store forces evict/readmit between
    batches; results match a fully-resident cache exactly (f32) and the
    routed search at recall >= 0.95 (int8)."""
    eng, X, Q = _engine()
    spec = SearchSpec(k=10, nprobe=4)
    ref = eng.search(Q, spec)
    cnts = np.sort(np.asarray(eng.ivf.part_counts))
    slots = int(cnts[-4:].sum())
    assert slots < eng.store.data.shape[0]
    small = spec.replace(hbm_slots=slots)
    for batch in (Q[:8], Q[8:], Q[:8], Q):
        r = eng.search(batch, small)
        assert r.plan.executor == "tiered-scan"
    got = eng.search(Q, small)
    np.testing.assert_array_equal(got.ids, ref.ids)
    got8 = eng.search(Q, small.replace(scan_dtype="int8"))
    assert _recall(got8.ids, ref.ids) >= 0.95


def test_tiered_oversized_demand_splits_instead_of_raising():
    """A slot pool smaller than one query's routed demand — smaller than a
    single bucket's extent — cuts oversized extents into region-sized
    sub-extents, scans them in passes, and merges top-k.  Direct cache
    misuse (no parts split) still refuses."""
    eng, X, Q = _engine()
    ref = eng.search(Q, SearchSpec(k=10, nprobe=8))
    res = eng.search(Q, SearchSpec(k=10, nprobe=8, hbm_slots=4))
    assert res.plan.executor == "tiered-scan"
    assert _recall(res.ids, ref.ids) == 1.0
    np.testing.assert_allclose(np.sort(res.dists, axis=1), np.sort(ref.dists, axis=1),
                               rtol=1e-5)
    cache = next(iter(eng.store._tiered_cache.values()))
    big = int(np.argmax(np.asarray(eng.ivf.part_counts)))
    with pytest.raises(ValueError, match="hbm_slots"):
        cache.ensure(np.array([big]))


def test_tiered_generation_invalidation_on_repack():
    """repack bumps tiles_version; the cache drops every slot and
    repopulates from the new extents."""
    eng, X, Q = _engine()
    spec = SearchSpec(k=10, nprobe=4, hbm_slots=64)
    rng = np.random.default_rng(7)
    new_ids = eng.insert(X[:3] + rng.standard_normal((3, X.shape[1]))
                         .astype(np.float32) * 0.01)  # upgrade to mutable
    eng.search(Q, spec)
    cache = next(iter(eng.store._tiered_cache.values()))
    gen0 = cache.generation
    assert cache.resident_slots > 0
    eng.delete(new_ids[:1])
    eng.compact()
    ref = eng.search(Q, SearchSpec(k=10, nprobe=4))
    got = eng.search(Q, spec)
    assert cache.generation != gen0
    np.testing.assert_array_equal(got.ids, ref.ids)


def test_bucket_cache_lru_evicts_unpinned_only():
    X, _ = _clustered(2000, 16, 8, seed=3)
    ivf = tivf.build_ivf(X, 8, capacity=64, **CPU)
    cnts = np.asarray(ivf.part_counts)
    cap = int(cnts.max() * 2 + 1)
    bc = BucketCache(ivf.store, capacity_slots=cap, dtype="f32",
                     part_offsets=ivf.part_offsets, part_counts=ivf.part_counts)
    bc.ensure(np.array([0, 1]))
    st = bc.ensure(np.array([2]))  # may evict 0 or 1, never 2
    assert st["misses"] == 1
    st2 = bc.ensure(np.array([2]))
    assert st2 == {"hits": 1, "misses": 0, "evicted": 0, "uploaded_slots": 0}


def test_host_quantize_matches_device_quantizers_bitwise():
    X, _ = _clustered(3000, 17, 8, seed=5)  # odd D: int4 pads a nibble
    ivf = tivf.build_ivf(X, 8, capacity=64, **CPU)
    for dtype, dev_fn in (("int8", tl._quantize_extent_int8),
                          ("int4", tl._quantize_extent_int4)):
        bc = BucketCache(ivf.store, capacity_slots=32, dtype=dtype,
                         part_offsets=ivf.part_offsets, part_counts=ivf.part_counts)
        bc._revalidate()
        data, _, _ = bc._masters()
        ext = np.asarray(data[:7], np.float32)
        host = bc._host_quantize(ext)
        dev = dev_fn(torch.from_numpy(ext), torch.from_numpy(bc._scale_np),
                     torch.from_numpy(bc._offset_np))
        assert torch.equal(host, dev)


def test_async_issue_wait_parity_with_sync_ensure():
    """The split prefetch (issue -> other work -> wait) leaves the cache in
    the state one synchronous ensure produces, for every pool dtype and
    every staging path; depth-1 discipline drains the previous ticket."""
    X, _ = _clustered(2000, 16, 8, seed=3)
    ivf = tivf.build_ivf(X, 8, capacity=64, **CPU)
    cap = int(np.asarray(ivf.part_counts).max() * 3 + 1)
    for dtype in DTYPES:
        def mk():
            return BucketCache(ivf.store, capacity_slots=cap, dtype=dtype,
                               part_offsets=ivf.part_offsets,
                               part_counts=ivf.part_counts)
        sync, asy, dev, leg = mk(), mk(), mk(), mk()
        asy.stage_on_host = True
        dev.stage_on_host = False
        leg.sync_uploads = True
        sync.ensure(np.array([0, 1, 2]))
        dev.ensure(np.array([0, 1, 2]))
        leg.ensure(np.array([0, 1, 2]))
        t1 = asy.issue(np.array([0, 1]))
        t2 = asy.issue(np.array([2]))   # depth-1: drains t1 first
        assert t1.done and not t2.done
        st = asy.wait(t2)
        assert st["misses"] == 1
        assert asy.wait(t2) == st       # idempotent settle
        ps, _, sbs, _, _ = sync.arrays()
        pa, _, sba, _, _ = asy.arrays()
        assert _bytes(ps) == _bytes(pa), dtype
        for other in (dev, leg):
            assert _bytes(ps) == _bytes(other.arrays()[0]), (
                dtype, other.stage_on_host, other.sync_uploads)
        assert torch.equal(sbs, sba)
        np.testing.assert_array_equal(sync.slot_ids_host(), asy.slot_ids_host())
        t3 = asy.issue(np.array([3]))
        _, ids_dev, _, _, _ = asy.arrays()
        assert t3.done
        slots = asy._resident[0][3]
        off = int(np.asarray(ivf.part_offsets)[3])
        cnt = int(np.asarray(ivf.part_counts)[3])
        np.testing.assert_array_equal(asy.slot_ids_host()[slots],
                                      ivf.store.ids.numpy()[off: off + cnt])
        np.testing.assert_array_equal(ids_dev.numpy()[slots],
                                      ivf.store.ids.numpy()[off: off + cnt])


def test_tree_routing_sublinear_cost():
    eng, X, Q = _engine(n=8000, d=16, nlist=128, tree=True, super_k=16,
                        nprobe_super=2)
    ivf = eng.ivf
    assert ivf.tree_enabled
    SK, M = ivf.super_children.shape
    assert ivf.routing_cost() == SK + ivf.nprobe_super * M
    assert ivf.routing_cost() < ivf.nlist
    ref = VectorSearchEngine.build(X, index="ivf", nlist=128, capacity=64,
                                   pruner="linear", tree=False, **CPU)
    r_tree = eng.search(Q, SearchSpec(k=10, nprobe=8))
    r_flat = ref.search(Q, SearchSpec(k=10, nprobe=8))
    assert _recall(r_tree.ids, r_flat.ids) >= 0.9


def test_tree_full_descent_matches_flat_exactly():
    X, Q = _clustered(3000, 24, 12, seed=5)
    flat = tivf.build_ivf(X, 12, capacity=64, tree=False, **CPU)
    tree = tivf.build_ivf(X, 12, capacity=64, tree=True, super_k=3, nprobe_super=3, **CPU)
    Qt = torch.from_numpy(Q)
    np.testing.assert_array_equal(flat.route_batch(Qt, nprobe=4),
                                  tree.route_batch(Qt, nprobe=4))


def test_tree_auto_threshold(monkeypatch):
    X, _ = _clustered(1500, 16, 8, seed=9)
    assert not tivf.build_ivf(X, 8, capacity=64, **CPU).tree_enabled
    monkeypatch.setattr(tivf, "TREE_AUTO_NLIST", 8)  # "auto" at the threshold
    assert tivf.build_ivf(X, 8, capacity=64, **CPU).tree_enabled


def test_tiered_obs_strict_noop_when_disabled():
    assert not _metrics.enabled()
    before = _metrics.get_registry().snapshot()
    eng, X, Q = _engine(n=2000, nlist=8)
    eng.search(Q, SearchSpec(k=5, nprobe=4, hbm_slots=64))
    eng.search(Q[:4], SearchSpec(k=5, nprobe=4, hbm_slots=48))
    assert _metrics.get_registry().snapshot() == before


def test_tiered_cache_gauges_recorded_when_enabled():
    _metrics.set_enabled(True)
    try:
        _metrics.get_registry().reset()
        eng, X, Q = _engine(n=2000, nlist=8)
        spec = SearchSpec(k=5, nprobe=4, hbm_slots=64)
        eng.search(Q, spec)
        eng.search(Q, spec)  # warm: all hits
        flat = str(eng.metrics())
        assert "repro_tiered_cache_events_total" in flat
        assert "repro_tiered_prefetch_bytes_total" in flat
        assert "hit" in flat and "miss" in flat
        assert "repro_cache_upload_wait_us" in flat
        reg = _metrics.get_registry()
        assert 0.0 <= reg.get("repro_cache_upload_overlap_ratio") <= 1.0
        assert reg.get("repro_tiered_cache_resident_slots") > 0
    finally:
        _metrics.set_enabled(False)
        _metrics.get_registry().reset()


def test_tiered_meters_match_reference(pair):
    """The tiered executor's counters (cache events, prefetch bytes,
    device bytes, routing bytes) equal the reference's on one batch."""
    from repro.obs import metrics as jm

    je, te, Q = pair
    kw = dict(k=5, nprobe=4, hbm_slots=20, scan_dtype="int4")
    got, want = {}, {}
    for m, eng, spec, out in ((_metrics, te, SearchSpec(**kw), got),
                              (jm, je, JSpec(kernel="jnp", **kw), want)):
        m.get_registry().reset()
        m.set_enabled(True)
        try:
            eng.search(Q, spec)
            eng.search(Q[:5], spec)
            snap = m.get_registry().snapshot()["counters"]
        finally:
            m.set_enabled(False)
            m.get_registry().reset()
        out.update({k: v for k, v in snap.items()
                    if k.startswith(("repro_tiered", "repro_device_bytes_total"))})
    assert got == want and got


def test_concurrent_admissions_keep_the_slot_tables_consistent():
    """Threads (more than cores) admitting random bucket sets at once, with
    a short switch interval: afterwards every slot is either free or owned
    by one resident extent, the slot tables agree with the owners, and each
    resident bucket's tiles and ids equal a fresh cache's."""
    import os
    import sys
    import threading

    ji, ts = _stores(seed=4)
    cap = int(np.asarray(ji.part_counts).max() * 3 + 1)
    kw = dict(capacity_slots=cap, dtype="int8", part_offsets=ji.part_offsets,
              part_counts=ji.part_counts)
    bc = BucketCache(ts, **kw)
    bc.stage_on_host = True  # the staging worker runs beside the threads
    errors = []

    def admit(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(25):
                bc.ensure(rng.choice(8, size=2, replace=False))
        except Exception as exc:  # noqa: BLE001 — reported by the assert below
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=admit, args=(i,))
                   for i in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    owned = np.concatenate([s for reg in bc._resident for s in reg.values()])
    assert sorted(owned.tolist() + bc._free[0]) == list(range(bc.capacity_slots))
    pool, ids_dev, _, _, _ = bc.arrays()
    fresh = BucketCache(ts, **kw)
    for b, slots in bc._resident[0].items():
        assert (bc._slot_bucket[slots] == b).all()
        fresh.ensure(np.array([b]))
        fslots = fresh._resident[0][b]
        fpool, fids, _, _, _ = fresh.arrays()
        assert torch.equal(pool[torch.from_numpy(slots)], fpool[torch.from_numpy(fslots)])
        assert torch.equal(ids_dev[torch.from_numpy(slots)], fids[torch.from_numpy(fslots)])
    free = np.asarray(bc._free[0], np.int64)
    assert (bc._slot_bucket[free] == -1).all()
