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
"""
import numpy as np
import pytest
import torch

from repro_torch.core import layout as tl
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import ref
from repro_torch.kernels.batched_matmul import batched_distance_quant_cuda
from repro_torch.kernels.ops import batched_distance_quant_op, pdx_prune_scan_multi_op
from repro_torch.kernels.pdx_scan import pdx_prune_scan_multi_cuda

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
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,D,V", [(4, 32, 64), (3, 50, 130), (65, 49, 1030)])
def test_k2_matches_plain(dev, B, D, V, metric, dtype):
    store, m = _mirror(3, D, V, dtype, B * D, dev)
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
