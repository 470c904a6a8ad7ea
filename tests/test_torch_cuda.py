"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Needs a CUDA device, ``nvcc`` and no JAX: each test carries the
``cuda`` marker and skips where no card is present.  Run on the GPU
machine with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerances (the kernels sum in another order and contract to FMA):
  * K1: alive masks differ only on lanes whose keep test came within 1e-4
    relative of its bound; dists allclose at rtol 1e-4 / atol 1e-3 where
    both keep the lane alive.
  * K2: |kernel - plain| <= 1e-5 * (||q||^2 + ||x^||^2) + 1e-3, the
    rounding scale of the cancelling form.
  * K3: K1's rule, and ``streamed`` equal on every partition whose alive
    masks agree.
  * The batched cascade stage (K2 per d-tile): K2's bound per tile summed
    over the tiles, and K1's rule for the alive masks.
  * K4, K5: rtol 1e-5 / atol 1e-4 at f32 and bf16 (both sides upcast bf16
    exactly and sum D terms in f32, in another order).
  * K6: K1's rule; on one partition K6 and K1 give equal masks and dists
    within rtol 1e-6 (the same sums in the same order; the compiler
    contracts them into FMAs differently, so the last bit may differ).
  * K7: K2's bound.
  * Near ties (``tests/test_torch_near_tie.py``): columns whose exact l2
    distances differ by about 1e-6 relative, which plain TF32 orders
    wrongly: K2 (f32, bf16, int8) and K7 (f32, bf16 tiles) order every
    column of every query as the plain f32 version does.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import layout as tl
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import ref
from repro_torch.kernels.batched_matmul import batched_distance_cuda, batched_distance_quant_cuda
from repro_torch.kernels.nary_scan import nary_distance_cuda
from repro_torch.kernels.ops import (
    batched_cascade_stage_op,
    batched_distance_op,
    batched_distance_quant_op,
    nary_distance_op,
    pdx_distance_op,
    pdx_prune_scan_multi_op,
    pdx_prune_scan_multi_prefetch_op,
    pdx_prune_scan_op,
)
from repro_torch.kernels.pdx_scan import (
    pdx_distance_cuda,
    pdx_prune_scan_cuda,
    pdx_prune_scan_multi_cuda,
    pdx_prune_scan_multi_prefetch_cuda,
)

from test_torch_near_tie import NEAR_TIE_DTYPES, near_tie_case

DTYPES = ("f32", "bf16", "int8", "int4")
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _mirror(P, D, V, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((P, D, V)).astype(np.float32)
    ids = rng.integers(0, 10_000, (P, V)).astype(np.int32)
    ids[:, -7:] = -1
    data[np.broadcast_to((ids < 0)[:, None, :], data.shape)] = tl.PAD_VALUE
    flat = np.swapaxes(data, 1, 2)[ids >= 0]
    store = tl.PDXStore(
        data=torch.from_numpy(data).to(dev), ids=torch.from_numpy(ids).to(dev),
        counts=torch.from_numpy((ids >= 0).sum(1).astype(np.int32)).to(dev),
        dim_means=torch.from_numpy(flat.mean(0)).to(dev),
        dim_vars=torch.from_numpy(flat.var(0)).to(dev),
    )
    return store, tl.device_mirror(store, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,D,V", [(3, 96, 130), (2, 49, 64), (4, 200, 1024), (1, 960, 2050)])
def test_k1_matches_plain(dev, P, D, V, dtype):
    store, m = _mirror(P, D, V, dtype, D * V, dev)
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(D).astype(np.float32)).to(dev)
    live0 = store.ids[0] >= 0
    full = torch.sum((store.data[0] - q[:, None]) ** 2, 0)[live0]
    thr = torch.sort(full).values[10]
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    n0 = pdx_prune_scan_multi_cuda.launches
    kd, ka = pdx_prune_scan_multi_op(m.data, store.ids, q, thr, sc, off,
                                     packed=m.packed, dim=m.dim)
    assert pdx_prune_scan_multi_cuda.launches == n0 + 1
    pd_, pa, walk = ref.pdx_prune_scan_multi_ref(m.data, store.ids, q, thr, d_tile=64,
                                                 eps0=2.1, scale=sc, offset=off,
                                                 packed=m.packed, dim=m.dim, trace=True)
    live = store.ids >= 0
    pa = pa != 0
    assert not ka[~live].any()
    mism = (ka != pa) & live
    if mism.any():
        assert float(walk.margin[mism].max()) < 1e-4
    both = ka & pa
    torch.testing.assert_close(kd[both], pd_[both], rtol=1e-4, atol=1e-3)
    # thr = +inf keeps every real lane, with its full distance
    kd, ka = pdx_prune_scan_multi_op(m.data, store.ids, q, float("inf"), sc, off,
                                     packed=m.packed, dim=m.dim)
    assert bool(ka[live].all())
    pd_, _ = ref.pdx_prune_scan_multi_ref(m.data, store.ids, q, float("inf"), d_tile=64,
                                          eps0=2.1, scale=sc, offset=off,
                                          packed=m.packed, dim=m.dim)
    torch.testing.assert_close(kd[live], pd_[live], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,D,V", [(3, 97, 130), (4, 200, 2050), (3, 961, 1030)])
def test_k3_matches_plain(dev, P, D, V, dtype):
    """A later cascade stage: partition 1 enters dead, and where V > 1024
    spreads a partition over several blocks, partition 2's first block
    enters dead while its others stream, so its count is their largest."""
    store, m = _mirror(P, D, V, dtype, D * V + 1, dev)
    ids = store.ids.clone()
    gen = torch.Generator(device="cpu").manual_seed(D)
    ids[(torch.rand(ids.shape, generator=gen) < 0.4).to(dev)] = -1
    ids[1] = -1
    ids[2, :1024] = -1
    q = torch.from_numpy(np.random.default_rng(2).standard_normal(D).astype(np.float32)).to(dev)
    live = ids >= 0
    real = store.ids >= 0
    full = torch.sum((store.data[0] - q[:, None]) ** 2, 0)[live[0]]
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    n_tiles = -(-D // 64)
    for thr in (torch.sort(full).values[10], float("inf")):
        n0 = pdx_prune_scan_multi_prefetch_cuda.launches
        kd, ka, ks = pdx_prune_scan_multi_prefetch_op(m.data, ids, q, thr, sc, off,
                                                      packed=m.packed, dim=m.dim)
        assert pdx_prune_scan_multi_prefetch_cuda.launches == n0 + 1
        pd_, pa, ps, walk = ref.pdx_prune_scan_multi_dskip_ref(
            m.data, ids, q, thr, d_tile=64, eps0=2.1, scale=sc, offset=off,
            packed=m.packed, dim=m.dim, trace=True)
        pa = pa != 0
        assert not ka[~live].any()
        mism = (ka != pa) & live
        if mism.any():
            assert float(walk.margin[mism].max()) < 1e-4
        both = ka & pa
        torch.testing.assert_close(kd[both], pd_[both], rtol=1e-4, atol=1e-3)
        agree = ~mism.any(dim=1)
        assert torch.equal(ks[agree], ps[agree])
        # entry-dead partition and lanes: nothing read, dist 0, alive false
        assert float(ks[1]) == 0 and not ka[1].any()
        assert bool((kd[real & ~live] == 0).all())
        if thr == float("inf"):
            assert bool(ka[live].all())
            assert ks.tolist() == [float(n_tiles) if bool(live[p].any()) else 0.0
                                   for p in range(P)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,D,V", [(4, 32, 64), (3, 50, 130), (65, 49, 1030), (64, 960, 1024),
                                   (1, 33, 130), (130, 96, 520)])
def test_k2_matches_plain(dev, B, D, V, metric, dtype):
    """(64, 960, 1024) is the main path's tile, at P = 4."""
    store, m = _mirror(4 if D == 960 else 3, D, V, dtype, B * D, dev)
    Q = torch.from_numpy(np.random.default_rng(D).standard_normal((B, D)).astype(np.float32)).to(dev)
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    n0 = batched_distance_quant_cuda.launches
    got = batched_distance_quant_op(m.data, Q, sc, off, metric, packed=m.packed, dim=m.dim)
    assert batched_distance_quant_cuda.launches == n0 + 1
    T32 = ref.dequantize_ref(m.data, sc, off, dim_axis=1, packed=m.packed, dim=m.dim)
    want = torch.cat([ref.batched_distance_ref(t, Q, metric) for t in T32], dim=1)
    live = (store.ids >= 0).reshape(-1)
    scale = (Q * Q).sum(1)[:, None] + (T32 * T32).sum(1).reshape(-1)[None, :]
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-3)[:, live].all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,D,S", [(3, 97, 130), (64, 960, 2048)])
def test_cascade_stage_matches_plain(dev, B, D, S, dtype):
    """K2 once per d-tile through the batched cascade stage, against the
    plain stage: K2's tolerance per tile summed over the tiles, and alive
    masks equal but on pairs whose keep test came within 1e-4 of the
    bound; slots no query keeps stay dead."""
    _, m = _mirror(1, D, S, dtype, B * D + 5, dev)
    gen = torch.Generator(device="cpu").manual_seed(S)
    Q = torch.randn((B, D), generator=gen).to(dev)
    alive = (torch.rand((B, S), generator=gen) < 0.6).to(dev)
    alive[:, :8] = False
    alive[:, -7:] = False  # PAD lanes
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    T = m.data[0]
    T32 = ref.dequantize_ref(T, sc, off, packed=m.packed, dim=m.dim)
    full = ((T32[None] - Q[:, :, None]) ** 2).sum(1)
    n_tiles = -(-D // 64)
    tol = 1e-5 * ((Q * Q).sum(1)[:, None] + (T32 * T32).sum(0)[None, :]) + 1e-3 * n_tiles
    for thr in (torch.quantile(full, 0.05, dim=1), torch.full((B,), float("inf"), device=dev)):
        n0 = batched_distance_quant_cuda.launches
        kd, ka = batched_cascade_stage_op(T, alive, Q, thr, sc, off, eps0=2.1,
                                          packed=m.packed, dim=m.dim)
        assert batched_distance_quant_cuda.launches == n0 + n_tiles
        pd_, pa, walk = ref.batched_cascade_stage_ref(T, alive, Q, thr, sc, off, eps0=2.1,
                                                      d_tile=64, packed=m.packed,
                                                      dim=m.dim, trace=True)
        pa = pa != 0
        assert not ka[~alive].any()
        mism = ka != pa
        if mism.any():
            assert float(walk.margin[mism].max()) < 1e-4
        both = ka & pa
        assert bool(((kd - pd_).abs() <= tol)[both].all())
        if thr.isinf().all():
            assert torch.equal(ka, alive)


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_on_the_card_matches_the_cpu(dev, dtype):
    """The fused executors on the card (the kernels) return the ids the CPU
    engine (their plain versions) returns for the same build."""
    X, Q = make_dataset(3000, 48, "clustered", n_queries=8, seed=3)
    kw = dict(pruner="adsampling", capacity=256)
    cpu = VectorSearchEngine.build(X, device="cpu", **kw)
    gpu = VectorSearchEngine.build(X, device=dev, **kw)
    spec = SearchSpec(k=5, scan_dtype=dtype)
    for q, executor in ((Q, "fused-batch"), (Q[0], "fused-scan")):
        n0 = (pdx_prune_scan_multi_cuda.launches, batched_distance_quant_cuda.launches)
        b = gpu.search(q, spec)
        a = cpu.search(q, spec.replace(executor=executor))
        assert b.plan.executor == executor
        assert (pdx_prune_scan_multi_cuda.launches, batched_distance_quant_cuda.launches) == (
            n0[0] + (executor == "fused-scan"), n0[1] + (executor == "fused-batch"))
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("cascade,k2_tiles", [
    (("proj32:int8", "int4", "f32"), 1 + 2),  # one projection tile, 96 / 64 dims
    (("bf16", "int8", "f32"), 2 + 2),
])
def test_cascade_on_the_card_matches_the_cpu(dev, cascade, k2_tiles):
    """Both cascade executors on the card (K1 then K3 per query; K2 per
    d-tile per batch) return the ids the CPU engine returns."""
    X, Q = make_dataset(3000, 96, "clustered", n_queries=8, seed=3)
    kw = dict(pruner="adsampling", capacity=256)
    cpu = VectorSearchEngine.build(X, device="cpu", **kw)
    gpu = VectorSearchEngine.build(X, device=dev, **kw)
    spec = SearchSpec(k=5, cascade=cascade)
    counters = (pdx_prune_scan_multi_cuda, pdx_prune_scan_multi_prefetch_cuda,
                batched_distance_quant_cuda)
    for q, executor, launches in ((Q, "cascade-batch", (0, 0, k2_tiles)),
                                  (Q[0], "cascade-scan", (1, 1, 0))):
        n0 = [c.launches for c in counters]
        b = gpu.search(q, spec)
        assert b.plan.executor == executor
        assert tuple(c.launches - n for c, n in zip(counters, n0)) == launches
        a = cpu.search(q, spec)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-2)
    s = gpu.search(Q, spec.replace(executor="cascade-scan"))
    np.testing.assert_array_equal(s.ids, gpu.search(Q, spec).ids)


def test_ivf_build_on_the_card_is_reproducible(dev):
    """One seed builds one index: k-means sums in a fixed order on the card,
    so two builds cut the same buckets into the same partitions."""
    X, _ = make_dataset(20000, 64, "clustered", n_queries=1, seed=2)
    a, b = (VectorSearchEngine.build(X, index="ivf", pruner="adsampling",
                                     capacity=256, device=dev) for _ in range(2))
    assert torch.equal(a.ivf.centroids, b.ivf.centroids)
    for name in ("data", "ids", "counts"):
        assert torch.equal(getattr(a.store, name), getattr(b.store, name))
    np.testing.assert_array_equal(a.ivf.part_counts, b.ivf.part_counts)


def _randn(shape, seed, dev, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
@pytest.mark.parametrize("D,V", [(8, 64), (33, 130), (130, 33), (960, 2050), (1536, 4096)])
def test_k4_matches_plain(dev, D, V, metric, dtype):
    """V % 4 != 0 takes the scalar loads; D = 1536 keeps q in 6 KB of
    shared memory."""
    T = _randn((D, V), D + V, dev, dtype)
    q = _randn((D,), D, dev, dtype)
    n0 = pdx_distance_cuda.launches
    got = pdx_distance_op(T, q, metric)
    assert pdx_distance_cuda.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (V,)
    torch.testing.assert_close(got, ref.pdx_distance_ref(T, q, metric), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
@pytest.mark.parametrize("N,D", [(64, 8), (130, 33), (1000, 128), (257, 12), (300, 1536),
                                 (1031, 4)])
def test_k5_matches_plain(dev, N, D, metric, dtype):
    """Groups of 1 to 32 threads a row; D = 33 (and 12 at bf16) take the
    scalar loads; N is not a multiple of a block's rows."""
    X = _randn((N, D), N + D, dev, dtype)
    q = _randn((D,), D, dev, dtype)
    n0 = nary_distance_cuda.launches
    got = nary_distance_op(X, q, metric)
    assert nary_distance_cuda.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (N,)
    torch.testing.assert_close(got, ref.nary_distance_ref(X, q, metric), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,D,V", [(4, 32, 64), (3, 50, 130), (65, 49, 1030), (64, 960, 4096),
                                   (1, 33, 130), (130, 96, 520)])
def test_k7_matches_plain(dev, B, D, V, metric, dtype):
    T = _randn((D, V), B + D + V, dev, dtype)
    Q = _randn((B, D), B * D, dev, dtype)
    n0 = batched_distance_cuda.launches
    got = batched_distance_op(T, Q, metric)
    assert batched_distance_cuda.launches == n0 + 1
    want = ref.batched_distance_ref(T, Q, metric)
    T32, Q32 = T.float(), Q.float()
    scale = (Q32 * Q32).sum(1)[:, None] + (T32 * T32).sum(0)[None, :]
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-3).all())


def _order_matches(got, want, pairs):
    rows = torch.arange(got.shape[0], device=got.device)[:, None]
    a, c = pairs[..., 0].to(got.device), pairs[..., 1].to(got.device)
    assert bool((got[rows, a] < got[rows, c]).all())
    assert torch.equal(torch.argsort(got, dim=1, stable=True),
                       torch.argsort(want, dim=1, stable=True))


@pytest.mark.parametrize("dtype", NEAR_TIE_DTYPES)
def test_k2_orders_near_ties_as_plain_f32(dev, dtype):
    T, Q, sc, off, pairs = near_tie_case(dtype)
    T, Q = T.to(dev), Q.to(dev)
    sc, off = (None, None) if sc is None else (sc.to(dev), off.to(dev))
    n0 = batched_distance_quant_cuda.launches
    got = batched_distance_quant_op(T, Q, sc, off, "l2")
    assert batched_distance_quant_cuda.launches == n0 + 1
    _order_matches(got, ref.batched_distance_quant_ref(T[0], Q, sc, off, "l2"), pairs)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k7_orders_near_ties_as_plain_f32(dev, dtype):
    """f32 queries on an f32 tile (six split products) and a bf16 tile
    (three)."""
    T, Q, _, _, pairs = near_tie_case(dtype)
    T, Q = T[0].to(dev), Q.to(dev)
    n0 = batched_distance_cuda.launches
    got = batched_distance_op(T, Q, "l2")
    assert batched_distance_cuda.launches == n0 + 1
    _order_matches(got, ref.batched_distance_ref(T, Q, "l2"), pairs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("thr_kind", ["k11", "q1", "zero", "inf"])
@pytest.mark.parametrize("D,V,d_tile,pad", [(96, 130, 64, True), (33, 1030, 16, False),
                                            (960, 2050, 64, True), (64, 5000, 32, True)])
def test_k6_matches_plain(dev, D, V, d_tile, pad, thr_kind, dtype):
    """K6 through its op against the plain scan: PAD lanes start dead, the
    last d-tile may be clipped, V spreads over several blocks; K1's rule
    for the masks and dists."""
    T = _randn((D, V), D * V, dev, dtype)
    q = _randn((D,), D + 1, dev)
    ids = None
    if pad:
        ids = torch.arange(V, dtype=torch.int32, device=dev)
        ids[[0, 5, V // 2]] = -1
        ids[-7:] = -1
    full = ref.pdx_distance_ref(T, q)
    thr = {"k11": torch.sort(full).values[10], "q1": torch.quantile(full, 0.01),
           "zero": torch.tensor(0.0, device=dev),
           "inf": torch.tensor(float("inf"), device=dev)}[thr_kind]
    n0 = pdx_prune_scan_cuda.launches
    kd, ka = pdx_prune_scan_op(T, q, thr, ids, eps0=2.1, d_tile=d_tile)
    assert pdx_prune_scan_cuda.launches == n0 + 1
    assert ka.dtype == torch.bool
    pd_, pa, walk = ref.pdx_prune_scan_ref(T, q, thr, d_tile=d_tile, eps0=2.1, ids=ids,
                                           trace=True)
    pa = pa != 0
    real = torch.ones(V, dtype=torch.bool, device=dev) if ids is None else ids >= 0
    assert not ka[~real].any()
    mism = ka != pa
    if mism.any():
        assert float(walk.margin[mism].max()) < 1e-4
    both = ka & pa
    torch.testing.assert_close(kd[both], pd_[both], rtol=1e-4, atol=1e-3)
    if thr_kind == "inf":
        assert bool(ka[real].all())
        torch.testing.assert_close(kd[real], full[real], rtol=1e-4, atol=1e-3)
    if thr_kind == "zero":
        assert not ka.any()


@pytest.mark.parametrize("thr_kind", ["k11", "inf"])
def test_k6_equals_k1_on_one_partition(dev, thr_kind):
    """K6 on a (D, C) partition and K1 on the same tile as a one-partition
    store, same ids and thr: equal masks, dists equal to the last bit or
    two."""
    store, m = _mirror(2, 960, 1024, "f32", 11, dev)
    q = _randn((960,), 12, dev)
    full = ref.pdx_distance_ref(store.data[1], q)[store.ids[1] >= 0]
    thr = torch.sort(full).values[10] if thr_kind == "k11" else float("inf")
    kd6, ka6 = pdx_prune_scan_op(store.data[1], q, thr, store.ids[1], eps0=2.1)
    kd1, ka1 = pdx_prune_scan_multi_op(store.data[1:2], store.ids[1:2], q, thr, eps0=2.1)
    assert torch.equal(ka6, ka1[0])
    torch.testing.assert_close(kd6, kd1[0], rtol=1e-6, atol=1e-5)
