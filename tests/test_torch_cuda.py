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
    masks agree.  K1 and K3 in their bulk body (aligned rows, a partition
    over several blocks fed by bulk copies): the same rules; ten launches
    back to back give equal outputs bit for bit.
  * The batched cascade stage (K2 per d-tile): K2's bound per tile summed
    over the tiles, and K1's rule for the alive masks.
  * K4, K5: rtol 1e-5 / atol 1e-4 at f32 and bf16 (both sides upcast bf16
    exactly and sum D terms in f32, in another order).
  * K6: K1's rule; on one partition K6 and K1 give equal masks and dists
    within rtol 1e-6 (the same sums in the same order; the compiler
    contracts them into FMAs differently, so the last bit may differ).
    Its sweep's survivor list holds exactly the plain walk's lanes after
    d-tile 0 at thr = 0 and +inf, and two calls on one workspace give
    equal outputs bit for bit.
  * K7: K2's bound.
  * Near ties (``tests/test_torch_near_tie.py``): columns whose exact l2
    distances differ by about 1e-6 relative, which plain TF32 orders
    wrongly: K2 (f32, bf16, int8) and K7 (f32, bf16 tiles) order every
    column of every query as the plain f32 version does.
"""
import functools

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
    pdx_prune_scan_geometry,
    pdx_prune_scan_multi_cuda,
    pdx_prune_scan_multi_geometry,
    pdx_prune_scan_multi_prefetch_cuda,
    pdx_prune_scan_workspace,
)

from test_torch_near_tie import NEAR_TIE_DTYPES, near_tie_case

DTYPES = ("f32", "bf16", "int8", "int4")
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _mirror(P, D, V, dtype, seed, dev, shift=None):
    """A (P, D, V) store of standard normal rows (plus ``shift`` (P, V) per
    lane, if given), the last 7 lanes of each partition PAD, and its mirror."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((P, D, V)).astype(np.float32)
    if shift is not None:
        data += shift[:, None, :]
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


# Lanes whose rows sit 3 standard deviations off the query die at the first
# d-tile (their estimate is ~5x the threshold there); lanes drawn like the
# query live on, some of them to the last tile.
FAR = 3.0


def _bulk_case(case, dtype, prefetch, dev):
    """(mirror, ids, q, thr) of a bulk-body case.

    * ``path``: the main path's tile, P = 24, D = 960, V = 1024: three
      partitions drawn near the query, the rest far, so most partitions die
      at tile 0 and a few live to the last tile (K3: random lanes, a whole
      partition and partition 11's first 256 lanes enter dead);
    * ``v2048``: P = 4, V = 2048, near and far lanes by block-sized groups,
      so some blocks of a partition die at their first vote while others
      live (K3: partition 2's lanes 1024-1279 enter dead);
    * ``thr0``: the path's tile at thr = 0, every block dies at tile 0;
    * ``inf``: the path's tile at thr = +inf, every block runs every tile.
    The threshold (path, v2048) is the 10th smallest full distance."""
    if case == "v2048":
        P, V = 4, 2048
        shift = np.full((P, V), FAR, np.float32)
        shift[[0, 2], 1024:] = 0.0
        shift[3, 1536:1664] = 0.0
    else:
        P, V = 24, 1024
        shift = np.full((P, V), FAR, np.float32)
        shift[[3, 11, 17]] = 0.0
    store, m = _mirror(P, 960, V, dtype, P + V, dev, shift)
    ids = store.ids.clone()
    if prefetch:
        gen = torch.Generator(device="cpu").manual_seed(V)
        ids[(torch.rand(ids.shape, generator=gen) < 0.3).to(dev)] = -1
        if case == "v2048":
            ids[2, 1024:1280] = -1
        else:
            ids[5] = -1
            ids[11, :256] = -1
    q = _randn((960,), 7, dev)
    if case == "thr0":
        return m, ids, q, 0.0
    if case == "inf":
        return m, ids, q, float("inf")
    T32 = ref.dequantize_ref(m.data, *((m.scale, m.offset) if m.quantized else (None, None)),
                             dim_axis=1, packed=m.packed, dim=m.dim)
    full = torch.sum((T32 - q[None, :, None]) ** 2, dim=1)[ids >= 0]
    return m, ids, q, torch.sort(full).values[10]


def _scan_vs_plain(m, ids, q, thr, prefetch):
    """One K1 (K3) launch through its op, held to the plain version by K1's
    (K3's) rule -> (kernel outputs, plain outputs, the plain walk)."""
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    op = pdx_prune_scan_multi_prefetch_op if prefetch else pdx_prune_scan_multi_op
    counter = pdx_prune_scan_multi_prefetch_cuda if prefetch else pdx_prune_scan_multi_cuda
    plain = ref.pdx_prune_scan_multi_dskip_ref if prefetch else ref.pdx_prune_scan_multi_ref
    n0 = counter.launches
    got = op(m.data, ids, q, thr, sc, off, packed=m.packed, dim=m.dim)
    assert counter.launches == n0 + 1
    *want, walk = plain(m.data, ids, q, thr, d_tile=64, eps0=2.1, scale=sc, offset=off,
                        packed=m.packed, dim=m.dim, trace=True)
    kd, ka, pd_, pa = got[0], got[1], want[0], want[1] != 0
    live = ids >= 0
    assert not ka[~live].any()
    mism = (ka != pa) & live
    if mism.any():
        assert float(walk.margin[mism].max()) < 1e-4
    both = ka & pa
    torch.testing.assert_close(kd[both], pd_[both], rtol=1e-4, atol=1e-3)
    if prefetch:
        agree = ~mism.any(dim=1)
        assert torch.equal(got[2][agree], want[2][agree])
    return got, want, walk


@pytest.mark.parametrize("prefetch", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["path", "v2048", "thr0", "inf"])
def test_bulk_scan_matches_plain(dev, case, dtype, prefetch):
    m, ids, q, thr = _bulk_case(case, dtype, prefetch, dev)
    assert pdx_prune_scan_multi_geometry(m.data, dim=960, d_tile=64, quantized=m.quantized,
                                         prefetch=prefetch)["body"] == "bulk"
    got, want, walk = _scan_vs_plain(m, ids, q, thr, prefetch)
    live = ids >= 0
    entering = live.any(dim=1)
    n_tiles = 15  # 960 dims / 64
    parts = walk.parts.tolist()
    if case == "path":
        # the far partitions die at tile 0; a near one lives to the last tile
        assert parts[1] == 3 and parts[-1] >= 1
    if case == "v2048":
        # every partition has live blocks after tile 0 but partition 1
        assert parts[1] == 3
    if case == "thr0":
        # every lane dies at its first vote, with tile 0's partial distance
        assert not got[1].any() and parts[1:] == [0] * (n_tiles - 1)
        torch.testing.assert_close(got[0][live], want[0][live], rtol=1e-4, atol=1e-3)
    if case == "inf":
        assert bool(got[1][live].all())
        torch.testing.assert_close(got[0][live], want[0][live], rtol=1e-4, atol=1e-3)
    if prefetch:
        if case in ("thr0", "inf"):
            want_streamed = (1.0 if case == "thr0" else float(n_tiles)) * entering.float()
            assert torch.equal(got[2], want_streamed)
        # entry-dead lanes read nothing and report dist 0, alive false
        real = m.data.shape[2] - 7
        dead = ~live
        dead[:, real:] = False
        assert bool((got[0][dead] == 0).all())


@pytest.mark.parametrize("prefetch", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bulk_scan_back_to_back(dev, dtype, prefetch):
    """Ten launches in a row, then one synchronize: a block that left with a
    bulk copy still in flight would corrupt a later block's ring or fault.
    Every launch gives the first one's outputs bit for bit."""
    m, ids, q, thr = _bulk_case("path", dtype, prefetch, dev)
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    op = pdx_prune_scan_multi_prefetch_op if prefetch else pdx_prune_scan_multi_op
    outs = [op(m.data, ids, q, thr, sc, off, packed=m.packed, dim=m.dim) for _ in range(10)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)


def _storage(dtype):
    """The torch dtype and stored rows per dim of a mirror of ``dtype``."""
    return {"f32": (torch.float32, 1), "bf16": (torch.bfloat16, 1), "int8": (torch.int8, 1),
            "int4": (torch.uint8, 2)}[dtype]


@pytest.mark.parametrize("thr_kind", ["inf", "q30"])
@pytest.mark.parametrize("prefetch", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bulk_tail_block_walks_several_items(dev, dtype, prefetch, thr_kind):
    """More items (partition, block of lanes) alive after tile 0 than tail
    blocks, so each tail block walks two or three of them one after the
    other on one ring, whose mbarriers are initialised once and whose phases
    run on from item to item.  D = 320 gives four tail d-tiles an item
    against a ring of three stages.  Every third item's rows sit FAR off the
    query in d-tile 1, every third in d-tile 3: at the 30 % quantile of the
    full distances those items die there, so items request 3 or 4 copies
    and the phases a block waits on shift from item to item; at +inf every
    item runs every tile.  K1's (K3's) rules against the plain version."""
    D, V = 320, 1024
    torch_dtype, per_row = _storage(dtype)
    kw = dict(dim=D, d_tile=64, quantized=dtype in ("int8", "int4"), prefetch=prefetch)
    # the tail's block cap, read where the items exceed it
    P = 64
    while True:
        probe = torch.empty((P, D // per_row, V), dtype=torch_dtype, device=dev)
        geo = pdx_prune_scan_multi_geometry(probe, **kw)
        del probe
        lanes = geo["lanes_per_block"]
        if P * (V // lanes) > 2 * geo["tail_blocks"]:
            break
        P *= 2
    cap = geo["tail_blocks"]
    nb = V // lanes
    P = -(-(5 * cap // 2) // nb)  # about 2.5 items a tail block
    gen = torch.Generator(device=dev).manual_seed(11)
    data = torch.randn((P, D, V), generator=gen, device=dev)
    item = torch.arange(P * nb, device=dev).reshape(P, nb, 1).expand(P, nb, lanes).reshape(P, V)
    for tile, group in ((1, 1), (3, 2)):
        data[:, 64 * tile:64 * (tile + 1), :] += FAR * (item % 3 == group)[:, None, :]
    ids = torch.randint(0, 10_000, (P, V), generator=gen, device=dev, dtype=torch.int32)
    ids[:, -7:] = -1
    data[(ids < 0)[:, None, :].expand_as(data)] = float(tl.PAD_VALUE)
    flat = data.transpose(1, 2)[ids >= 0]
    store = tl.PDXStore(data=data, ids=ids, counts=(ids >= 0).sum(1).to(torch.int32),
                        dim_means=flat.mean(0), dim_vars=flat.var(0, unbiased=False))
    del flat
    m = tl.device_mirror(store, dtype)
    geo = pdx_prune_scan_multi_geometry(m.data, **kw)
    assert geo["body"] == "bulk" and geo["tail_blocks"] == cap
    assert P * nb >= 2 * cap
    if prefetch:
        ids = ids.clone()
        ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.3] = -1
    q = torch.randn((D,), generator=gen, device=dev)
    if thr_kind == "inf":
        thr = float("inf")
    else:
        T32 = ref.dequantize_ref(m.data, *((m.scale, m.offset) if m.quantized else (None, None)),
                                 dim_axis=1, packed=m.packed, dim=m.dim)
        full = torch.sum((T32 - q[None, :, None]) ** 2, dim=1)[ids >= 0]
        del T32
        thr = torch.sort(full).values[int(0.3 * full.numel())]
    got, want, walk = _scan_vs_plain(m, ids, q, thr, prefetch)
    lanes_in = walk.lanes.tolist()
    # every item enters the tail, so a tail block walks two or three
    assert walk.parts.tolist()[1] == P
    if thr_kind == "inf":
        assert bool(got[1][ids >= 0].all())
    else:
        assert lanes_in[1] > lanes_in[2] and lanes_in[3] > lanes_in[4] > 0


@pytest.mark.parametrize("dtype,lanes", [("f32", 128), ("bf16", 256), ("int8", 256),
                                         ("int4", 256)])
def test_scan_geometry_follows_the_shape(dev, dtype, lanes):
    """The bulk body where every row segment is 16-byte aligned and a d-tile
    of a block is at most 32 KB: a sweep of one stage a block, a persistent
    tail of three stages, each beside the {q, scale, offset} table of its
    dims; the direct body on unaligned rows or an unaligned base."""
    _, m = _mirror(2, 96, 1024, dtype, 3, dev)
    kw = dict(dim=96, d_tile=64, quantized=m.quantized)
    rows = 32 if dtype == "int4" else 64
    stage = rows * lanes * m.data.element_size()
    geo = pdx_prune_scan_multi_geometry(m.data, **kw)
    tail_blocks = geo.pop("tail_blocks")
    assert 0 < tail_blocks <= 2 * 1024 // lanes
    # ring stages, their mbarriers (32 bytes), 16 bytes a dim of the table
    assert geo == {"body": "bulk", "lanes_per_block": lanes, "blocks": 2 * 1024 // lanes,
                   "smem_bytes": 3 * stage + 32 + 32 * 16,
                   "smem_bytes_sweep": stage + 32 + 64 * 16, "lookahead_tiles": 2}
    direct = {"body": "direct", "lanes_per_block": 1024, "blocks": 2, "tail_blocks": 0,
              "smem_bytes": 3 * 96 * 4, "smem_bytes_sweep": 3 * 96 * 4,  # q, scale, offset
              "lookahead_tiles": 0}
    _, m = _mirror(2, 96, 130, dtype, 3, dev)
    assert pdx_prune_scan_multi_geometry(m.data, **kw) == direct
    _, m = _mirror(2, 96, 1024, dtype, 3, dev)
    flat = torch.empty(m.data.numel() + 1, dtype=m.data.dtype, device=dev)
    shifted = flat[1:].view(m.data.shape)
    assert shifted.data_ptr() % 16 != 0
    assert pdx_prune_scan_multi_geometry(shifted, **kw) == direct


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
@pytest.mark.parametrize("D,V", [(8, 64), (33, 130), (130, 33), (960, 2050), (1536, 4096),
                                 (64, 1028), (96, 4100), (200, 100), (17, 3), (50, 1021)])
def test_k4_matches_plain(dev, D, V, metric, dtype):
    """V % 4 != 0 takes the scalar loads (a thread's lanes at the ragged
    end too, where V is not a multiple of the lanes a thread: 1028, 4100);
    V = 100 and 3 are less than one block; D = 1536 keeps q in 6 KB of
    shared memory."""
    T = _randn((D, V), D + V, dev, dtype)
    q = _randn((D,), D, dev, dtype)
    n0 = pdx_distance_cuda.launches
    got = pdx_distance_op(T, q, metric)
    assert pdx_distance_cuda.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (V,)
    torch.testing.assert_close(got, ref.pdx_distance_ref(T, q, metric), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_unaligned_base_takes_scalar_loads(dev, dtype):
    """A (D, V) view 4 bytes (2 at bf16) past an aligned base, V % 8 == 0:
    its rows are not 16-byte aligned, so the kernel must not read them as
    vectors."""
    D, V = 96, 2048
    flat = _randn((D * V + 1,), 3, dev, dtype)
    T = flat[1:].view(D, V)
    q = _randn((D,), 4, dev)
    for metric in ("l2", "ip", "l1"):
        torch.testing.assert_close(pdx_distance_op(T, q, metric),
                                   ref.pdx_distance_ref(T, q, metric), rtol=1e-5, atol=1e-4)
    kd, ka = pdx_prune_scan_op(T, q, float("inf"), eps0=2.1)
    assert bool(ka.all())
    torch.testing.assert_close(kd, ref.pdx_distance_ref(T, q), rtol=1e-4, atol=1e-3)


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


@functools.lru_cache(maxsize=1)
def _clustered(D, V):
    """(V, D) clustered rows and one query, ``make_dataset``'s mixture:
    lanes of one cluster are scattered over V, as on the flat block."""
    X, Q = make_dataset(V, D, "clustered", n_queries=1, seed=D + V)
    return X, Q[0]


CLUSTERED_V = 131_072


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("thr_kind", ["k11", "q1", "zero", "inf"])
@pytest.mark.parametrize("D,V,d_tile,pad", [(96, 130, 64, True), (33, 1030, 16, False),
                                            (960, 2050, 64, True), (64, 5000, 32, True),
                                            (128, 4099, 32, True), (320, CLUSTERED_V, 64, True)])
def test_k6_matches_plain(dev, D, V, d_tile, pad, thr_kind, dtype):
    """K6 through its op against the plain scan: PAD lanes start dead, the
    last d-tile may be clipped, V spreads over several blocks; K1's rule
    for the masks and dists.  V = CLUSTERED_V takes clustered data, whose
    survivors after d-tile 0 are scattered over many warps and blocks of
    the sweep, so the tail gathers lanes far apart."""
    if V == CLUSTERED_V:
        X, qn = _clustered(D, V)
        T = torch.from_numpy(np.ascontiguousarray(X.T)).to(dev).to(dtype)
        q = torch.from_numpy(qn).to(dev)
    else:
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


def _k6_case(D, V, dtype, dev, seed=0):
    """A (D, V) partition of standard normal rows, a query, PAD lanes at 0,
    5, V // 2 and the last 7, and the plain full distances."""
    T = _randn((D, V), seed + D * V, dev, dtype)
    q = _randn((D,), seed + D + 1, dev)
    ids = torch.arange(V, dtype=torch.int32, device=dev)
    ids[[0, 5, V // 2]] = -1
    ids[-7:] = -1
    return T, q, ids, ref.pdx_distance_ref(T, q)


def _k6_vs_plain(T, q, ids, thr, d_tile, workspace=None):
    """K6 (the wrapper, on ``workspace`` if given) held to the plain scan by
    K1's rule -> (dists, alive, the plain walk)."""
    thr_t = torch.as_tensor(thr, dtype=torch.float32, device=T.device).reshape(1)
    kd, ka = pdx_prune_scan_cuda(T, ids, q, thr_t, d_tile=d_tile, eps0=2.1, workspace=workspace)
    pd_, pa, walk = ref.pdx_prune_scan_ref(T, q, thr_t[0], d_tile=d_tile, eps0=2.1, ids=ids,
                                           trace=True)
    pa = pa != 0
    assert not ka[ids < 0].any()
    mism = ka != pa
    if mism.any():
        assert float(walk.margin[mism].max()) < 1e-4
    both = ka & pa
    torch.testing.assert_close(kd[both], pd_[both], rtol=1e-4, atol=1e-3)
    return kd, ka, walk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("thr_kind", ["inf", "q30"])
def test_k6_tail_warps_refill_from_the_list(dev, dtype, thr_kind):
    """A list three times what the tail's threads hold at once (V from the
    launch shape, not a multiple of 4, D = 200: four d-tiles, the last
    clipped), so every warp refills from the list: at +inf after each
    lane's last d-tile, at the 30 % quantile as lanes die at every tile."""
    geo = pdx_prune_scan_geometry(torch.empty((200, 8), device=dev, dtype=dtype), d_tile=64)
    assert geo["body"] == "list" and geo["tail_blocks"] > 0
    V = 3 * geo["tail_blocks"] * geo["tail_threads"] + 5
    T, q, ids, full = _k6_case(200, V, dtype, dev)
    real = ids >= 0
    thr = float("inf") if thr_kind == "inf" else torch.quantile(full[real], 0.3)
    ws = pdx_prune_scan_workspace(V, dev)
    kd, ka, walk = _k6_vs_plain(T, q, ids, thr, 64, ws)
    lanes = walk.lanes.tolist()
    if thr_kind == "inf":
        assert int(ws[0]) == int(real.sum()) > 2 * geo["tail_blocks"] * geo["tail_threads"]
        assert bool(ka[real].all())
        torch.testing.assert_close(kd[real], full[real], rtol=1e-4, atol=1e-3)
    else:
        assert lanes[1] > lanes[2] > lanes[3] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("thr_kind", ["inf", "zero"])
def test_k6_list_holds_the_lanes_alive_after_tile_0(dev, dtype, thr_kind):
    """The sweep's list: at +inf every real lane, each once and in lane
    order; at 0 none (the tail exits at once) — the plain walk's lanes
    entering d-tile 1."""
    D, V = 200, 5003
    T, q, ids, _ = _k6_case(D, V, dtype, dev, seed=1)
    thr = float("inf") if thr_kind == "inf" else 0.0
    ws = pdx_prune_scan_workspace(V, dev)
    ws.fill_(-5)  # its contents on entry do not matter
    _, ka, walk = _k6_vs_plain(T, q, ids, thr, 64, ws)
    count = int(ws[0])
    assert count == int(walk.lanes[1])
    geo = pdx_prune_scan_geometry(T, d_tile=64)
    nb, lanes = geo["sweep_blocks"], geo["segment_lanes"]
    offsets = ws[3:3 + nb + 1].tolist()
    assert offsets[0] == 0 and offsets[-1] == count
    segments = ws[3 + nb + 1:].split(lanes)
    listed = torch.cat([seg[:hi - lo] for seg, lo, hi in zip(segments, offsets, offsets[1:])])
    if thr_kind == "inf":
        assert torch.equal(listed.long(), torch.nonzero(ids >= 0).flatten())
    else:
        assert count == 0 and not ka.any()


@pytest.mark.parametrize("D,d_tile", [(200, 64), (48, 64)])
def test_k6_counts_one_launch_per_call(dev, D, d_tile):
    """``.launches`` counts wrapper calls: one for the sweep and tail
    together (D = 200), one for a sweep alone (D = 48, one d-tile)."""
    T, q, ids, full = _k6_case(D, 1030, torch.float32, dev)
    n0 = pdx_prune_scan_cuda.launches
    for thr in (float("inf"), torch.sort(full).values[10], 0.0):
        pdx_prune_scan_op(T, q, thr, ids, eps0=2.1, d_tile=d_tile)
    assert pdx_prune_scan_cuda.launches == n0 + 3
    geo = pdx_prune_scan_geometry(T, d_tile=d_tile)
    assert (geo["tail_blocks"] > 0) == (D > d_tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_back_to_back_on_one_workspace(dev, dtype):
    """Two calls at one threshold on one workspace, with a call at +inf
    between them, queued without a synchronize: equal outputs bit for bit,
    and held to the plain scan."""
    T, q, ids, full = _k6_case(960, 20_000, dtype, dev, seed=2)
    thr = torch.sort(full[ids >= 0]).values[10].reshape(1)
    ws = pdx_prune_scan_workspace(20_000, dev)
    inf = torch.full((1,), float("inf"), device=dev)
    a = pdx_prune_scan_cuda(T, ids, q, thr, d_tile=64, eps0=2.1, workspace=ws)
    pdx_prune_scan_cuda(T, ids, q, inf, d_tile=64, eps0=2.1, workspace=ws)
    b = pdx_prune_scan_cuda(T, ids, q, thr, d_tile=64, eps0=2.1, workspace=ws)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _k6_vs_plain(T, q, ids, thr, 64, ws)


def _churned_pair(dev, seed=5):
    """A flat ADSampling engine on the card at D = 960, n = 8192 (8
    partitions of 1024), churned: 600 ids deleted at random (tombstones in
    the middle of every partition), 300 rows inserted through a write-head
    of 256 (a flush into the freed slots, 44 rows left live in the head).
    Its state carried to the CPU (``convert``) is the plain side."""
    from repro_torch.convert import engine_from_arrays, mutable_store_arrays

    X, Q = make_dataset(8192, 960, "clustered", n_queries=8, seed=seed)
    gpu = VectorSearchEngine.build(X, pruner="adsampling", capacity=1024, device=dev)
    rng = np.random.default_rng(seed)
    dead = rng.choice(8192, size=600, replace=False)
    assert gpu.delete(dead) == 600
    new, _ = make_dataset(300, 960, "clustered", n_queries=1, seed=seed + 1)
    new_ids = gpu.insert(new)
    store = gpu.store
    assert isinstance(store, tl.MutablePDXStore) and store.device.type == "cuda"
    assert store.head_count == 44
    ids = store.ids.cpu().numpy()
    assert ((ids[:, :-1] < 0) & (ids[:, 1:] >= 0)).any()  # holes mid-partition
    arrays = {**mutable_store_arrays(store), "pruner": "adsampling",
              "eps0": gpu.pruner.aux["eps0"], "rotation": gpu.pruner.aux["rotation"]}
    cpu = engine_from_arrays(arrays, device="cpu")
    return gpu, cpu, Q, dead, new, new_ids


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_churned_store_on_the_card_matches_the_cpu(dev, dtype):
    """fused-scan (K1), fused-batch (K2) and cascade-scan (K1 then K3) over
    a churned store on the card return the ids its state returns on the
    CPU through the plain versions, before and after ``compact``; no
    tombstoned id comes back, inserted rows find themselves at rank 0."""
    gpu, cpu, Q, dead, new, new_ids = _churned_pair(dev)
    counters = (pdx_prune_scan_multi_cuda, batched_distance_quant_cuda,
                pdx_prune_scan_multi_prefetch_cuda)
    cases = [(Q[0], "fused-scan", SearchSpec(k=10, scan_dtype=dtype), (1, 0, 0)),
             (Q, "fused-batch", SearchSpec(k=10, scan_dtype=dtype), (0, 1, 0)),
             (Q[1], "cascade-scan", SearchSpec(k=10, cascade=("proj32:int8", "int4", "f32")),
              (1, 0, 1))]
    for phase in ("churned", "compacted"):
        for q, executor, spec, launches in cases:
            n0 = [c.launches for c in counters]
            b = gpu.search(q, spec)
            assert b.plan.executor == executor
            assert tuple(c.launches - n for c, n in zip(counters, n0)) == launches
            a = cpu.search(q, spec.replace(executor=executor))
            np.testing.assert_array_equal(a.ids, b.ids, err_msg=f"{phase} {executor}")
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-2)
            assert not np.isin(b.ids, dead).any()
        mine = [0, 1, 2, 3, 296, 297, 298, 299]  # sealed by the flush, then head rows
        own = gpu.search(new[mine], SearchSpec(k=3))
        assert own.plan.executor == "fused-batch"
        np.testing.assert_array_equal(own.ids[:, 0], new_ids[mine])
        gpu.compact()
        cpu.compact()


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_tombstoned_columns_never_return_at_ip(dev, dtype):
    """Tombstoned columns hold PAD_VALUE = 3e18: at the ip metric they
    would rank first (-q.x), and through K2's exact split their norm
    overflows; the positions from the post-mutation ids mask them."""
    gpu, cpu, Q, dead, _, _ = _churned_pair(dev, seed=6)
    spec = SearchSpec(k=10, metric="ip", scan_dtype=dtype)
    b = gpu.search(Q, spec)
    assert b.plan.executor == "fused-batch"
    a = cpu.search(Q, spec.replace(executor="fused-batch"))
    np.testing.assert_array_equal(a.ids, b.ids)
    assert not np.isin(b.ids, dead).any() and (b.ids >= 0).all()
    assert np.isfinite(b.dists).all()


# ------------------------------------------------------------ tiered serving
def _ivf_stores(dev, n=6000, D=96, nlist=12, capacity=256, seed=11):
    """One IVF build's store as a CPU PDXStore and a CUDA PDXStore holding
    the same arrays, with its bucket extents."""
    from repro_torch.index.ivf import build_ivf

    X, Q = make_dataset(n, D, "clustered", n_queries=8, seed=seed)
    ivf = build_ivf(X, nlist, capacity=capacity, device="cpu")
    s = ivf.store
    gpu = tl.PDXStore(*(getattr(s, k).to(dev) for k in
                        ("data", "ids", "counts", "dim_means", "dim_vars")))
    return s, gpu, ivf, Q


def _cache(store, ivf, dtype, path, cap):
    bc = tl.BucketCache(store, capacity_slots=cap, dtype=dtype,
                        part_offsets=ivf.part_offsets, part_counts=ivf.part_counts)
    bc.stage_on_host = path == "worker"
    bc.sync_uploads = path == "legacy"
    return bc


@pytest.mark.parametrize("path", ["worker", "device", "legacy"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiered_pool_on_the_card_equals_the_cpu_cache(dev, dtype, path):
    """One sequence of ensure/issue/wait leaves the CUDA cache's pool, id
    table and slot tables equal bit for bit to the CPU cache's (pinned
    staging, the side stream, the device quantizer on the card)."""
    cpu_s, gpu_s, ivf, _ = _ivf_stores(dev)
    cap = int(ivf.part_counts.max() * 3 + 1)
    caches = [_cache(s, ivf, dtype, path, cap) for s in (cpu_s, gpu_s)]
    stats = []
    for bc in caches:
        seq = [bc.ensure(np.array([0, 1, 2]))]
        t = bc.issue(np.array([3, 1]))
        seq.append(bc.wait(bc.issue(np.array([4]))))
        seq += [t.stats, bc.ensure(np.array([5, 0, 6])), bc.ensure(np.array([7, 2]))]
        stats.append(seq)
    assert stats[0] == stats[1] and any(s["evicted"] for s in stats[0])
    (cp, cid, csb, csc, coff), (gp, gid, gsb, gsc, goff) = (c.arrays() for c in caches)
    assert gp.device.type == "cuda"
    for a, b in ((cp, gp), (cid, gid), (csb, gsb), (csc, gsc), (coff, goff)):
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16 else a,
                           (b.view(torch.uint8) if b.dtype == torch.bfloat16 else b).cpu())
    np.testing.assert_array_equal(caches[0].slot_ids_host(), caches[1].slot_ids_host())
    # the device quantizer on the card equals the host's bit for bit
    ext = np.ascontiguousarray(cpu_s.data[:5].numpy())
    host = caches[1]._host_quantize(ext)
    devq = caches[1]._device_quantize(torch.from_numpy(ext).to(dev)).cpu()
    if host.dtype == torch.bfloat16:
        host, devq = host.view(torch.int16), devq.view(torch.int16)
    assert torch.equal(host, devq)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_tiered_upload_never_changes_an_enqueued_scan(dev, dtype):
    """The in-place hazard: a pool scan of bucket ``a`` enqueued behind a
    long spin of the card, then ``issue`` + ``wait`` of a bucket ``b`` of
    the same size in a pool that holds one, so ``b`` takes every slot the
    scan reads.  ``wait`` writes the pool in stream order after the scan,
    so the scan returns what it returns with no upload in between, while
    the pool afterwards holds ``b``."""
    from repro_torch.core.plan import _tiered_pool_scan

    _, gpu_s, ivf, Q = _ivf_stores(dev)
    cnts = ivf.part_counts
    a, b = next((x, y) for x in range(len(cnts)) for y in range(x + 1, len(cnts))
                if cnts[x] == cnts[y] > 0)
    bc = _cache(gpu_s, ivf, dtype, "worker", int(cnts[a]))
    bc.ensure(np.array([a]))
    slots = bc._resident[0][a]
    sel = torch.full((4, 1), a, device=dev)
    Qd = torch.from_numpy(Q[:4]).to(dev)

    def scan():
        pool, ids, sb, sc, off = bc.arrays()
        return _tiered_pool_scan(pool, ids, sb, sel, Qd, sc, off, 10, "l2",
                                 bc.quantized, packed=bc.packed, dim=bc.dim)

    want = scan()
    torch.cuda.synchronize()
    assert (want.ids >= 0).all()
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card ahead of the scan
    got = scan()
    st = bc.wait(bc.issue(np.array([b])))
    assert st["evicted"] == 1 and st["uploaded_slots"] == len(slots)
    assert np.array_equal(np.sort(bc._resident[0][b]), np.sort(slots))
    torch.cuda.synchronize()
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dists, want.dists)
    off_b = int(ivf.part_offsets[b])
    ids_b = gpu_s.ids[off_b:off_b + len(slots)]
    order = np.argsort(bc._resident[0][b])
    assert torch.equal(bc.arrays()[1][torch.from_numpy(np.sort(bc._resident[0][b])).to(dev)],
                       ids_b[torch.from_numpy(order).to(dev)])


def test_kernel_torch_with_hbm_slots_on_a_cuda_store_raises(dev):
    X, Q = make_dataset(3000, 48, "clustered", n_queries=4, seed=3)
    gpu = VectorSearchEngine.build(X, index="ivf", nlist=8, pruner="adsampling",
                                   capacity=256, device=dev)
    with pytest.raises(ValueError, match="kernel='torch'"):
        gpu.search(Q, SearchSpec(k=5, hbm_slots=8, kernel="torch"))
    assert gpu.plan(Q, SearchSpec(k=5, hbm_slots=8)).executor == "tiered-scan"


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiered_scan_on_the_card_matches_the_cpu(dev, dtype):
    """tiered-scan on the card launches K2 once per (chunk, pass) step and
    returns the ids the CPU engine (the plain K2) returns on the same
    build, at a pool small enough to chunk and evict; a swap is allowed
    only between neighbours whose exact distances lie within 1e-5
    relative (f32 scans K2's split product, 5.7e-5 off exact)."""
    from repro_torch.core import plan as tplan

    X, Q = make_dataset(6000, 96, "clustered", n_queries=16, seed=12)
    kw = dict(index="ivf", nlist=12, pruner="adsampling", capacity=256, seed=1)
    cpu = VectorSearchEngine.build(X, device="cpu", **kw)
    gpu = VectorSearchEngine.build(X, device=dev, **kw)
    assert torch.equal(gpu.store.ids.cpu(), cpu.store.ids)
    cnts = gpu.ivf.part_counts
    slots = int(np.sort(cnts)[-3:].sum())
    spec = SearchSpec(k=10, nprobe=3, hbm_slots=slots, scan_dtype=dtype)
    Qt = gpu.pruner.transform_batch(torch.from_numpy(Q).to(dev))
    sel = gpu.ivf.route_batch(Qt, 3)
    chunks = tplan._tiered_chunks(sel, cnts, lambda b: 0, slots)
    steps = sum(len(tplan._chunk_passes(sel[c], cnts, lambda b: 0, slots)) for c in chunks)
    for _ in range(2):  # cold, then warm
        n0 = batched_distance_quant_cuda.launches
        b = gpu.search(Q, spec)
        assert b.plan.executor == "tiered-scan"
        assert batched_distance_quant_cuda.launches - n0 == steps
    a = cpu.search(Q, spec)
    np.testing.assert_allclose(b.dists, a.dists, rtol=1e-5, atol=1e-4)
    for ai, ad, bi in zip(a.ids, a.dists, b.ids):
        for j in np.nonzero(ai != bi)[0]:
            near = np.abs(ad - ad[j]) <= 1e-5 * np.abs(ad[j])
            assert bi[j] in ai[near], (ai, bi, ad)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_served_burst_on_the_card_equals_engine_search(dev, dtype):
    """A closed-loop burst of 16 queries through ``VectorServer`` drains as
    one bucket-16 batch (``fused-batch``, K2 launched) and returns, query by
    query, the ids and distances of ``engine.search`` on the same batch;
    then a single query (``fused-scan``, K1) equals its blocking search.
    Nothing is built after ``warmup()``."""
    from repro_torch.serve import VectorServer

    X, Q = make_dataset(3000, 48, "clustered", n_queries=17, seed=3)
    gpu = VectorSearchEngine.build(X, index="ivf", nlist=8, pruner="adsampling",
                                   capacity=256, device=dev)
    spec = SearchSpec(k=5, scan_dtype=dtype)
    want = gpu.search(Q[:16], spec)
    want1 = gpu.search(Q[16], spec)
    srv = VectorServer(gpu, spec=spec, max_batch=16, flush_interval_s=5.0)
    try:
        srv.warmup()
        n0 = (pdx_prune_scan_multi_cuda.launches, batched_distance_quant_cuda.launches)
        res = [f.result(timeout=30) for f in [srv.submit(q) for q in Q[:16]]]
        assert batched_distance_quant_cuda.launches > n0[1]
        single = srv.submit(Q[16])
    finally:
        srv.close()
    got1 = single.result(timeout=30)
    assert pdx_prune_scan_multi_cuda.launches == n0[0] + 1
    np.testing.assert_array_equal(np.stack([r[0] for r in res]), want.ids)
    np.testing.assert_array_equal(np.stack([r[1] for r in res]), want.dists)
    np.testing.assert_array_equal(got1[0], want1.ids)
    np.testing.assert_array_equal(got1[1], want1.dists)
    assert srv.jit_compiles_since_warmup() == 0


def test_batch_block_sharded_on_a_world_of_one_equals_fused_batch(dev):
    """On a world of one (NCCL), ``batch-block-sharded`` at int8 scans the
    whole store as one shard through K2 and equals ``fused-batch`` bit for
    bit: one shard, no padding, the same arithmetic; K2 launches in it and
    one all-gather crosses the (one-rank) mesh.  ``route_batch`` rows equal
    ``route`` bit for bit on the card."""
    import torch.distributed as tdist

    from repro_torch.dist import make_mesh
    from repro_torch.obs.meters import collective_counts

    X, Q = make_dataset(8192, 96, "clustered", n_queries=16, seed=3)
    eng = VectorSearchEngine.build(X, index="ivf", pruner="adsampling",
                                   capacity=256, device=dev)
    spec = SearchSpec(k=10, scan_dtype="int8")
    want = eng.search(Q, spec.replace(executor="fused-batch"))
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        before = batched_distance_quant_cuda.launches
        got = eng.search(Q, spec.replace(executor="batch-block-sharded"), mesh=mesh)
        assert batched_distance_quant_cuda.launches > before
        counts = collective_counts(lambda: eng.search(
            Q, spec.replace(executor="batch-block-sharded"), mesh=mesh))
    finally:
        tdist.destroy_process_group()
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)
    assert counts == {"all_gather": 1}
    Qt = eng.pruner.transform_batch(torch.from_numpy(Q).to(dev))
    for dt in DTYPES:
        rows = eng.ivf.route_batch(Qt, eng.ivf.nlist, "l2", dt)
        for i in range(len(Q)):
            np.testing.assert_array_equal(rows[i], eng.ivf.rank_buckets(Qt[i], "l2", dt))


def test_routed_executors_on_a_world_of_one(dev):
    """On a world of one (NCCL) an IVF engine on a ("data",) mesh plans
    ``routed_bucket``: at int8 it launches K2 over the rank's buckets and
    gives the f32 routed answer (plain matrix products, exact within the
    routed buckets; ids as sets), a batch whose demand spills into two exchange rounds
    equals the same rows of an unspilled batch, and the collectives are
    one all-to-all per round and one all-gather; with ``hbm_slots`` it
    plans ``routed_tiered``, which equals ``tiered-scan`` bit for bit on
    the same warm cache."""
    import torch.distributed as tdist

    from repro_torch.dist import make_mesh
    from repro_torch.obs.meters import collective_counts

    X, Q = make_dataset(8192, 96, "clustered", n_queries=40, seed=3)
    eng = VectorSearchEngine.build(X, index="ivf", pruner="adsampling",
                                   capacity=256, device=dev)
    spec = SearchSpec(k=10, nprobe=4, scan_dtype="int8")
    tiered = SearchSpec(k=10, nprobe=4, hbm_slots=eng.store.num_partitions // 2,
                        scan_dtype="int8")
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        before = batched_distance_quant_cuda.launches
        got = eng.search(Q[:16], spec, mesh=mesh)
        assert batched_distance_quant_cuda.launches > before
        want = eng.search(Q[:16], spec.replace(scan_dtype="f32"), mesh=mesh)
        spilled = eng.search(Q, spec, mesh=mesh)
        counts = [collective_counts(lambda: eng.search(Q[:b], spec, mesh=mesh))
                  for b in (16, 40)]
        t_want = eng.search(Q[:16], tiered.replace(executor="tiered-scan"))
        t_got = eng.search(Q[:16], tiered, mesh=mesh)
    finally:
        tdist.destroy_process_group()
    assert got.plan.executor == "routed_bucket" and t_got.plan.executor == "routed_tiered"
    for a, b in zip(got.ids, want.ids):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_array_equal(spilled.ids[:16], got.ids)
    assert counts == [{"all_to_all": 1, "all_gather": 1},
                      {"all_to_all": 2, "all_gather": 1}]
    np.testing.assert_array_equal(t_got.ids, t_want.ids)
    np.testing.assert_array_equal(t_got.dists, t_want.dists)


# ------------------------------------------------- LM serving and RAG
def _lm_pair(dev, cache_len=96):
    """A reduced llama3.2-3b drawn once on the CPU, and the same weights on
    the card, each in a ``GenerationEngine``."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve import GenerationEngine

    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg)
    cpu_p = model.init(torch.Generator().manual_seed(0), device="cpu")

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d) for k, v in tree.items()}

    return (cfg, GenerationEngine(model=model, params=cpu_p, cache_len=cache_len),
            GenerationEngine(model=model, params=to(cpu_p, dev), cache_len=cache_len))


def test_generation_on_the_card_equals_the_cpu(dev):
    """Greedy tokens equal, prefill and decode logits within 1e-5 + 1e-4
    |cpu| (f32 with TF32 off: the same products summed in another order),
    on the same weights."""
    cfg, cpu, gpu = _lm_pair(dev)
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (3, 8)).astype(np.int32)}
    np.testing.assert_array_equal(gpu.generate(batch, max_new_tokens=5),
                                  cpu.generate(batch, max_new_tokens=5))
    lc, cc = cpu.model.prefill(cpu.params, batch, 16)
    lg, cg = gpu.model.prefill(gpu.params, batch, 16)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4, atol=1e-5)
    tok = torch.argmax(lc, -1)[:, None]
    lc, _ = cpu.model.decode_step(cpu.params, tok, cc, 8)
    lg, _ = gpu.model.decode_step(gpu.params, tok.to(dev), cg, 8)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gpu.embed(batch), cpu.embed(batch), rtol=1e-4, atol=1e-5)


def _to(tree, d):
    return {k: _to(v, d) if isinstance(v, dict) else v.to(d) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["internvl2-1b", "deepseek-moe-16b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b", "mamba2-370m", "whisper-small"])
def test_family_generation_on_the_card_equals_the_cpu(dev, arch):
    """Each of the other families reduced, on the same weights and batch
    (its patch embeddings or encoder frames included): greedy tokens equal,
    prefill and two decode steps' logits within 1e-5 + 1e-4 |cpu| (f32, TF32
    off: the same products summed in another order)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_concrete_batch
    from repro_torch.models.lm import build_model
    from repro_torch.serve import GenerationEngine

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu_p = model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu_p = _to(cpu_p, dev)
    batch = {k: v.numpy() for k, v in
             make_concrete_batch(cfg, 16, 3, "prefill", seed=1, device="cpu").items()}
    cpu = GenerationEngine(model=model, params=cpu_p, cache_len=24)
    gpu = GenerationEngine(model=model, params=gpu_p, cache_len=24)
    np.testing.assert_array_equal(gpu.generate(batch, max_new_tokens=5),
                                  cpu.generate(batch, max_new_tokens=5))
    lc, cc = model.prefill(cpu_p, batch, 24)
    lg, cg = model.prefill(gpu_p, batch, 24)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4, atol=1e-5)
    pos = 16
    for t in range(2):
        tok = torch.argmax(lc, -1)[:, None]
        lc, cc = model.decode_step(cpu_p, tok, cc, pos + t)
        lg, cg = model.decode_step(gpu_p, tok.to(dev), cg, pos + t)
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pruner", ["adsampling", "bond"])
def test_rag_on_the_card_retrieves_the_cpu_ids(dev, pruner):
    """The same documents and queries: on the card a batch plans
    ``fused-batch`` (one K2 launch) and a single query ``fused-scan`` (one
    K1 launch); on the CPU ``batch-matmul`` and ``adaptive``.  Both return
    the same ids, and the answers' doc ids and tokens are equal."""
    from repro_torch.serve import RagPipeline

    cfg, cpu, gpu = _lm_pair(dev)
    rng = np.random.default_rng(1)
    docs = rng.integers(0, cfg.vocab, (40, 12)).astype(np.int32)
    crag = RagPipeline.build(cpu, docs, pruner=pruner, retrieve_k=3, device="cpu")
    grag = RagPipeline.build(gpu, docs, pruner=pruner, retrieve_k=3, device=dev)
    assert grag.store.device.type == "cuda"
    q = {"tokens": rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32)}
    for batch, executor in ((q, "fused-batch"), ({"tokens": q["tokens"][:1]}, "fused-scan"),
                            ({"tokens": docs[[2, 9, 31]]}, "fused-batch")):
        emb = gpu.embed(batch)
        assert grag.store.plan(emb).executor == executor
        n0 = (pdx_prune_scan_multi_cuda.launches, batched_distance_quant_cuda.launches)
        got = grag.retrieve(batch)
        k1 = pdx_prune_scan_multi_cuda.launches - n0[0]
        k2 = batched_distance_quant_cuda.launches - n0[1]
        assert (k1, k2) == ((0, 1) if executor == "fused-batch" else (1, 0))
        np.testing.assert_array_equal(got, crag.retrieve(batch))
    out, ids = grag.answer(q, max_new_tokens=3)
    want_out, want_ids = crag.answer(q, max_new_tokens=3)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(out, want_out)
    new = rng.integers(0, cfg.vocab, (3, 12)).astype(np.int32)
    assert grag.add_documents(new).tolist() == [40, 41, 42]
    assert grag.retrieve({"tokens": new[1:2]})[0, 0] == 41


# ------------------------------------------------------------------ training
def test_chunked_loss_and_its_grads_on_the_card_equal_the_full_logits(dev):
    """``chunked_ce_loss`` (chunks of 64 over S = 256, V = 4099) against
    ``F.cross_entropy`` over the full logits under autograd, on the card:
    the loss at rtol 1e-5, the grads of h and the head within rtol 1e-4
    and atol 1e-5 x their largest |grad|."""
    import torch.nn.functional as F

    from repro_torch.models.lm import chunked_ce_loss

    rng = np.random.default_rng(0)
    B, S, d, V = 4, 256, 96, 4099
    h = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((d, V)) * 0.1).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, V, (B, S))).to(dev)
    h.requires_grad_()
    w.requires_grad_()
    loss = chunked_ce_loss(h, labels, w, chunk=64)
    gh, gw = torch.autograd.grad(loss, (h, w))
    full = F.cross_entropy((h @ w).reshape(-1, V), labels.reshape(-1))
    fh, fw = torch.autograd.grad(full, (h, w))
    np.testing.assert_allclose(loss.item(), full.item(), rtol=1e-5)
    for got, want in ((gh, fh), (gw, fw)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


def _plain_update(kind, p, g, s, cfg):
    """The reference's functional update (``repro/train/optimizer.py``),
    out of place in plain PyTorch, one leaf: -> (new p, new state)."""
    from repro_torch.train.optimizer import _factored

    norm = torch.sqrt(torch.sum(torch.square(g)))
    g = g * torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-9), max=1.0)
    step = s["step"] + 1
    lr = cfg.lr * torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1), max=1.0)
    t = step.to(torch.float32)
    if kind == "adamw":
        mu = s["mu"] * cfg.b1 + g * (1 - cfg.b1)
        nu = s["nu"] * cfg.b2 + g * g * (1 - cfg.b2)
        delta = (mu / (1.0 - cfg.b1 ** t)) / (torch.sqrt(nu / (1.0 - cfg.b2 ** t)) + cfg.eps)
        delta = delta + cfg.weight_decay * p
        return p - lr * delta, {"mu": mu, "nu": nu, "step": step}
    beta2 = 1.0 - t ** (-0.8)
    g2 = g * g + 1e-30
    vr, vc, v = s["vr"], s["vc"], s["v"]
    if _factored(p.shape):
        vr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
        vc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
        r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
        update = g * torch.rsqrt(r[..., None] * vc[..., None, :] + 1e-30)
    else:
        v = beta2 * v + (1 - beta2) * g2
        update = g * torch.rsqrt(v + 1e-30)
    update = update / torch.clamp(torch.sqrt(torch.mean(update * update) + 1e-30), min=1.0)
    return p - lr * update - lr * cfg.weight_decay * p, {"vr": vr, "vc": vc, "v": v,
                                                         "step": step}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("shape", [(3, 257, 130), (1000,)])
def test_in_place_update_on_the_card_equals_a_plain_update(dev, kind, shape):
    """``opt_update``'s in-place leaf update against the reference's math
    out of place, on card tensors, over three steps (clipped and not):
    the same elementwise operations in the same order, so equal to 1e-6
    relative (the only freedom is the reductions' order)."""
    from repro_torch.train.optimizer import OptConfig, opt_init, opt_update

    cfg = OptConfig(lr=1e-2, warmup_steps=2, kind=kind)
    rng = np.random.default_rng(len(shape))
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    params = {"w": p.clone()}
    state = opt_init(params, cfg)
    plain_p, plain_s = p, {k: (v["w"] if isinstance(v, dict) else v) for k, v in state.items()}
    plain_s = {k: v.clone() for k, v in plain_s.items()}
    for i, scale in enumerate((1e-4, 3.0, 0.01)):
        g = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)
        params, state, m = opt_update({"w": g}, state, params, cfg)
        plain_p, plain_s = _plain_update(kind, plain_p, g, plain_s, cfg)
        assert params["w"].device.type == dev.type and int(state["step"]) == i + 1
        np.testing.assert_allclose(params["w"].cpu().numpy(), plain_p.cpu().numpy(),
                                   rtol=1e-6, atol=1e-7)
        for k, v in plain_s.items():
            got = state[k] if k == "step" else state[k]["w"]
            np.testing.assert_allclose(got.cpu().numpy(), v.cpu().numpy(), rtol=1e-6,
                                       atol=1e-30)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """Two AdamW steps (remat on) of the reduced llama on the same weights
    and batches: losses at rtol 1e-5, the params' difference's
    ``global_norm`` below 1e-3 (the reference's accumulation bar)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.lm import build_model
    from repro_torch.train.optimizer import OptConfig, global_norm, opt_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg)
    oc = OptConfig(lr=1e-2, warmup_steps=0)
    cpu_p = model.init(torch.Generator().manual_seed(0), device="cpu")

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d, copy=True)
                for k, v in tree.items()}

    gpu_p = to(cpu_p, dev)
    cpu_s, gpu_s = opt_init(cpu_p, oc), opt_init(gpu_p, oc)
    step = make_train_step(model, TrainConfig(opt=oc))
    stream = TokenStream(cfg, 32, 4, seed=1)
    for i in range(2):
        b = stream.batch_at(i)
        cpu_p, cpu_s, mc = step(cpu_p, cpu_s, b)
        gpu_p, gpu_s, mg = step(gpu_p, gpu_s, b)
        assert mg["loss"].device.type == dev.type
        np.testing.assert_allclose(mg["loss"].item(), mc["loss"].item(), rtol=1e-5)
    d = global_norm(_sub(to(gpu_p, "cpu"), cpu_p))
    assert float(d) < 1e-3


def _sub(a, b):
    return {k: _sub(v, b[k]) if isinstance(v, dict) else v - b[k] for k, v in a.items()}
