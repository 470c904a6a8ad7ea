"""The port's kernel ops on the CPU (their plain PyTorch versions) vs the
reference ops running the Pallas kernels in interpret mode.

K1 ``pdx_prune_scan_multi_op`` and K2 ``batched_distance_quant_op`` take
the same mirror bytes on both sides, at every scan dtype, including an odd
D for the packed int4 mirror and PAD lanes.  Tolerances:
  * K1: alive masks equal; dists allclose at rtol 1e-4 / atol 1e-4 on
    lanes with ids >= 0 (f32 sums of <= 200 squares in another order; PAD
    lanes hold NaN in both plain bodies and are meaningless).
  * K2: the reference test's own tolerances — rtol/atol 1e-3 for f32 and
    the int mirrors, rtol 3e-2 / atol 5e-1 for bf16 operands (the Pallas
    interpret body and the plain body round the bf16 tile at different
    points of the cancelling form).
  * K3 ``pdx_prune_scan_multi_prefetch_op`` (the cascade's later stages):
    K1's tolerances, and ``streamed`` equal.
  * ``batched_cascade_stage_op`` (K2 per d-tile): alive masks equal, dists
    at K2's tolerances, on non-PAD lanes.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import (
    batched_cascade_stage_op as j_stage,
    batched_distance_quant_op as j_bmm,
    pdx_prune_scan_multi_op as j_scan,
    pdx_prune_scan_multi_prefetch_op as j_prefetch,
)
from repro_torch.core import layout as tl
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import (
    batched_cascade_stage_op as t_stage,
    batched_distance_quant_op as t_bmm,
    pdx_prune_scan_multi_op as t_scan,
    pdx_prune_scan_multi_prefetch_op as t_prefetch,
)

DTYPES = ("f32", "bf16", "int8", "int4")


def _mirror(P, D, V, dtype, seed):
    """A port store of random tiles with PAD lanes and its mirror."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((P, D, V)).astype(np.float32)
    ids = rng.integers(0, 10_000, (P, V)).astype(np.int32)
    ids[:, -7:] = -1
    ids[0, 3] = -1
    data[np.broadcast_to((ids < 0)[:, None, :], data.shape)] = tl.PAD_VALUE
    flat = np.swapaxes(data, 1, 2)[ids >= 0]
    store = tl.PDXStore(
        data=torch.from_numpy(data), ids=torch.from_numpy(ids),
        counts=torch.from_numpy((ids >= 0).sum(1).astype(np.int32)),
        dim_means=torch.from_numpy(flat.mean(0)),
        dim_vars=torch.from_numpy(flat.var(0)),
    )
    return store, tl.device_mirror(store, dtype)


def _jnp(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,D,V", [(3, 96, 130), (2, 49, 64), (1, 200, 256)])
@pytest.mark.parametrize("pruned", [True, False])
def test_prune_scan_multi_plain_matches_reference(P, D, V, dtype, pruned):
    store, m = _mirror(P, D, V, dtype, seed=D + V)
    rng = np.random.default_rng(P)
    q = rng.standard_normal(D).astype(np.float32)
    live0 = store.ids[0] >= 0
    full = torch.sum((store.data[0] - torch.from_numpy(q)[:, None]) ** 2, 0)[live0]
    thr = np.float32(np.partition(full.numpy(), 10)[10]) if pruned else np.float32(np.inf)
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    got_d, got_a = t_scan(m.data, store.ids, torch.from_numpy(q), torch.tensor(thr),
                          sc, off, packed=m.packed, dim=m.dim)
    want_d, want_a = j_scan(
        _jnp(m.data), _jnp(store.ids), jnp.asarray(q), jnp.float32(thr),
        None if sc is None else _jnp(sc), None if off is None else _jnp(off),
        use_pallas=True, packed=m.packed, dim=m.dim,
    )
    assert got_a.dtype == torch.bool
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    real = store.ids.numpy() >= 0
    np.testing.assert_allclose(got_d.numpy()[real], np.asarray(want_d)[real],
                               rtol=1e-4, atol=1e-4)
    assert not got_a.numpy()[~real].any()
    if not pruned:  # thr = +inf keeps every real lane alive
        assert got_a.numpy()[real].all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,D,V", [(4, 32, 64), (3, 50, 130), (3, 49, 130)])
def test_batched_distance_quant_plain_matches_reference(B, D, V, metric, dtype):
    store, m = _mirror(2, D, V, dtype, seed=B * D)
    Q = np.random.default_rng(D).standard_normal((B, D)).astype(np.float32)
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    got = t_bmm(m.data, torch.from_numpy(Q), sc, off, metric,
                packed=m.packed, dim=m.dim)
    tol = dict(rtol=3e-2, atol=5e-1) if dtype == "bf16" else dict(rtol=1e-3, atol=1e-3)
    real = store.ids.numpy().reshape(-1) >= 0
    want = np.concatenate([
        np.asarray(j_bmm(
            _jnp(m.data[p]), jnp.asarray(Q), None if sc is None else _jnp(sc),
            None if off is None else _jnp(off), metric, True,
            packed=m.packed, dim=m.dim,
        )) for p in range(2)
    ], axis=1)
    assert got.shape == (B, 2 * V)  # stacked tiles: column p * V + v
    np.testing.assert_allclose(got.numpy()[:, real], want[:, real], **tol)
    one = t_bmm(m.data[1], torch.from_numpy(Q), sc, off, metric,
                packed=m.packed, dim=m.dim)
    np.testing.assert_array_equal(one.numpy(), got.numpy()[:, V:])


def _stage_ids(store, seed):
    """A later cascade stage's ids: a previous stage killed partition 1
    whole (it enters dead) and about 40 % of the other lanes."""
    ids = store.ids.clone()
    ids[torch.from_numpy(np.random.default_rng(seed).random(ids.shape) < 0.4)] = -1
    ids[1] = -1
    return ids


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,D,V", [(4, 96, 130), (3, 49, 64)])
@pytest.mark.parametrize("pruned", [True, False])
def test_prefetch_scan_plain_matches_reference(P, D, V, dtype, pruned):
    store, m = _mirror(P, D, V, dtype, seed=D * V)
    ids = _stage_ids(store, D)
    q = np.random.default_rng(P).standard_normal(D).astype(np.float32)
    live0 = store.ids[0] >= 0
    full = torch.sum((store.data[0] - torch.from_numpy(q)[:, None]) ** 2, 0)[live0]
    thr = np.float32(np.partition(full.numpy(), 10)[10]) if pruned else np.float32(np.inf)
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    got_d, got_a, got_s = t_prefetch(m.data, ids, torch.from_numpy(q), torch.tensor(thr),
                                     sc, off, d_tile=16, packed=m.packed, dim=m.dim)
    want_d, want_a, want_s = j_prefetch(
        _jnp(m.data), _jnp(ids), jnp.asarray(q), jnp.float32(thr),
        None if sc is None else _jnp(sc), None if off is None else _jnp(off),
        d_tile=16, use_pallas=True, packed=m.packed, dim=m.dim,
    )
    assert got_a.dtype == torch.bool and got_s.shape == (P,)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[1] == 0 and not got_a[1].any()  # entry-dead: fetches nothing
    real = store.ids.numpy() >= 0  # the lanes holding data (not PAD)
    np.testing.assert_allclose(got_d.numpy()[real], np.asarray(want_d)[real],
                               rtol=1e-4, atol=1e-4)
    # the same dists and alive mask as K1's plain walk on the same ids
    k1_d, k1_a = t_scan(m.data, ids, torch.from_numpy(q), torch.tensor(thr), sc, off,
                        d_tile=16, packed=m.packed, dim=m.dim)
    assert torch.equal(k1_a, got_a) and torch.equal(k1_d[real], got_d[real])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,D,V", [(4, 50, 130), (3, 49, 64)])
def test_batched_cascade_stage_plain_matches_reference(B, D, V, dtype):
    store, m = _mirror(1, D, V, dtype, seed=B + D)
    rng = np.random.default_rng(V)
    Q = rng.standard_normal((B, D)).astype(np.float32)
    alive = rng.random((B, V)) < 0.7
    alive[:, 5:9] = False                      # slots no query keeps
    alive &= store.ids.numpy()[0] >= 0
    T32 = tref.dequantize_ref(m.data, m.scale, m.offset, dim_axis=1,
                              packed=m.packed, dim=m.dim)[0].numpy()
    full = ((T32[None, :, :V - 7] - Q[:, :, None]) ** 2).sum(1)  # PAD lanes last
    thr = np.partition(full, 20, axis=1)[:, 20].astype(np.float32)
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    got_d, got_a = t_stage(m.data[0], torch.from_numpy(alive), torch.from_numpy(Q),
                           torch.from_numpy(thr), sc, off, eps0=2.1, d_tile=16,
                           packed=m.packed, dim=m.dim)
    want_d, want_a = j_stage(
        _jnp(m.data[0]), jnp.asarray(alive), jnp.asarray(Q), jnp.asarray(thr),
        None if sc is None else _jnp(sc), None if off is None else _jnp(off),
        eps0=2.1, d_tile=16, use_pallas=True, packed=m.packed, dim=m.dim,
    )
    real = store.ids.numpy()[0] >= 0
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert not got_a.numpy()[:, 5:9].any() and got_a.numpy().any()
    tol = dict(rtol=3e-2, atol=5e-1) if dtype == "bf16" else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_d.numpy()[:, real], np.asarray(want_d)[:, real], **tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_cascade_stage_trace(dtype):
    """The plain stage's trace: pairs and slots alive entering each d-tile,
    and the keep test's margin, over the op's own result."""
    store, m = _mirror(1, 49, 64, dtype, seed=3)
    rng = np.random.default_rng(5)
    Q = torch.from_numpy(rng.standard_normal((3, 49)).astype(np.float32))
    alive = torch.from_numpy(rng.random((3, 64)) < 0.6) & (store.ids[0] >= 0)
    alive[:, :4] = False
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    thr = torch.full((3,), 40.0)
    got_d, got_a = t_stage(m.data[0], alive, Q, thr, sc, off, eps0=2.1, d_tile=16,
                           packed=m.packed, dim=m.dim)
    d, a, walk = tref.batched_cascade_stage_ref(m.data[0], alive, Q, thr, sc, off, eps0=2.1,
                                                d_tile=16, packed=m.packed, dim=m.dim,
                                                trace=True)
    assert torch.equal(got_d, d) and torch.equal(got_a, a != 0)
    assert walk.lanes.shape == walk.parts.shape == (4,)  # 49 dims in 16-wide tiles
    assert int(walk.lanes[0]) == int(alive.sum())
    assert int(walk.parts[0]) == int(alive.any(dim=0).sum())
    assert bool((walk.lanes[1:] <= walk.lanes[:-1]).all())
    assert bool(torch.isinf(walk.margin[~alive]).all())
    assert bool(torch.isfinite(walk.margin[alive]).all())


def test_dequantize_ref_unpacks_odd_int4():
    _, m = _mirror(2, 7, 16, "int4", seed=0)
    t32 = tref.dequantize_ref(m.data, m.scale, m.offset, dim_axis=1,
                              packed=True, dim=7)
    lv = tl.unpack_int4(m.data, dim_axis=1, dim=7).float()
    want = lv * m.scale[None, :, None] + m.offset[None, :, None]
    assert t32.shape == (2, 7, 16)
    np.testing.assert_array_equal(t32.numpy(), want.numpy())


def test_ops_refuse_unsupported_metric():
    _, m = _mirror(1, 8, 16, "f32", seed=0)
    with pytest.raises(ValueError, match="l2 or ip"):
        t_bmm(m.data, torch.zeros(2, 8), metric="l1")


# ------------------------------------------- K2/K7: the tensor-core operands
@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16_planes_sum_exactly(seed):
    """Three bf16 planes carry all 24 bits of an f32: they sum back to the
    value exactly, each at most 2^-8 of the one before; one or two planes
    (bf16, or TF32-like width) do not."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((65, 97)).astype(np.float32)
    x *= (np.float32(10.0) ** rng.integers(-20, 21, x.shape)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, tl.PAD_VALUE, 1.0 + 2.0 ** -23]
    X = torch.from_numpy(x)
    planes = tref.split_bf16(X)
    assert planes.shape == (3, 65, 97) and planes.dtype == torch.bfloat16
    p = planes.float()
    assert torch.equal((p[0] + p[1]) + p[2], X)
    for hi, lo in ((p[0], p[1]), (p[1], p[2])):
        assert bool((lo.abs() <= hi.abs() * 2.0 ** -8).all())
    assert not torch.equal(p[0] + p[1], X)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_fold_scale_planes_sum_to_scaled_queries(dtype):
    _, m = _mirror(1, 33, 16, dtype, seed=3)
    Q = torch.from_numpy(np.random.default_rng(4).standard_normal((5, 33)).astype(np.float32))
    Qs, qo = tref.fold_scale(Q, m.scale, m.offset)
    assert torch.equal(Qs, Q * m.scale[None, :])
    np.testing.assert_allclose(qo.numpy(), (Q.double() @ m.offset.double()).numpy(),
                               rtol=1e-6, atol=1e-6)
    p = tref.split_bf16(Qs).float()
    assert torch.equal((p[0] + p[1]) + p[2], Qs)


@pytest.mark.parametrize("B,D", [(1, 33), (64, 960), (130, 49)])
def test_split_bf16_of_bf16_values_is_one_plane(B, D):
    """K7 takes bf16 queries as one plane of their f32 values: the split of
    a bf16 value is the value itself and two zero planes."""
    Q = torch.from_numpy(np.random.default_rng(B + D).standard_normal((B, D))
                         .astype(np.float32)).to(torch.bfloat16)
    planes = tref.split_bf16(Q.float())
    assert torch.equal(planes[0], Q)
    assert not planes[1:].float().any()


@pytest.mark.parametrize("D", [33, 960])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_six_product_split_matches_plain(D, metric):
    """What the tensor-core K2/K7 compute on an f32 tile, in plain f32
    torch: queries and tile each in three bf16 planes, the six products
    ``q_i x_j`` with ``i + j <= 2`` (each exact), smallest first -> the
    plain version within K2's tolerance, ``1e-5 * (||q||^2 + ||x||^2) +
    1e-3``, on live columns."""
    store, m = _mirror(2, D, 130, "f32", seed=D)
    Q = torch.from_numpy(np.random.default_rng(D + 2).standard_normal((5, D))
                         .astype(np.float32))
    qp = tref.split_bf16(Q).float()
    qn = torch.sum(Q * Q, dim=1)
    got, scale = [], []
    for t in m.data:
        xp = tref.split_bf16(t).float()
        cross = torch.zeros((5, t.shape[1]))
        for total in (2, 1, 0):
            for i in range(total + 1):
                cross = cross + qp[i] @ xp[total - i]
        xn = torch.sum(t * t, dim=0)
        got.append(-cross if metric == "ip" else (qn[:, None] - 2.0 * cross) + xn[None, :])
        scale.append(qn[:, None] + xn[None, :])
    got, scale = torch.cat(got, dim=1), torch.cat(scale, dim=1)
    want = t_bmm(m.data, Q, metric=metric)
    live = (store.ids >= 0).reshape(-1)
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-3)[:, live].all())


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("D", [33, 960])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_folded_split_product_matches_plain(D, dtype, metric):
    """What the tensor-core K2 computes on a quantized mirror, in plain f32
    torch: ``(q * s)`` in three bf16 planes times the int8 levels (each
    product exact), smallest plane first, plus ``q . o``, and the norms of
    ``x^ = x s + o`` -> the plain version within K2's tolerance,
    ``1e-5 * (||q||^2 + ||x^||^2) + 1e-3``, on live columns."""
    store, m = _mirror(2, D, 130, dtype, seed=D)
    B = 5
    Q = torch.from_numpy(np.random.default_rng(D + 1).standard_normal((B, D))
                         .astype(np.float32))
    Qs, qo = tref.fold_scale(Q, m.scale, m.offset)
    planes = tref.split_bf16(Qs).float()
    levels = tref.dequantize_ref(m.data, None, None, dim_axis=1, packed=m.packed, dim=D)
    xhat = tref.dequantize_ref(m.data, m.scale, m.offset, dim_axis=1, packed=m.packed, dim=D)
    got, want, scale = [], [], []
    qn = torch.sum(Q * Q, dim=1)
    for lv, xh in zip(levels, xhat):
        cross = (planes[2] @ lv + planes[1] @ lv) + planes[0] @ lv + qo[:, None]
        xn = torch.sum(xh * xh, dim=0)
        got.append(-cross if metric == "ip" else (qn[:, None] - 2.0 * cross) + xn[None, :])
        scale.append(qn[:, None] + xn[None, :])
    got, scale = torch.cat(got, dim=1), torch.cat(scale, dim=1)
    want = t_bmm(m.data, Q, m.scale, m.offset, metric, packed=m.packed, dim=m.dim)
    live = (store.ids >= 0).reshape(-1)
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-3)[:, live].all())


def test_scan_geometry_refuses_cpu_tensors():
    """K1/K3's launch shape comes from the CUDA library's own rule, for a
    CUDA mirror only: a CPU tensor raises before any library is built."""
    from repro_torch.kernels.pdx_scan import pdx_prune_scan_multi_geometry

    with pytest.raises(ValueError, match="CUDA tensor"):
        pdx_prune_scan_multi_geometry(torch.zeros((1, 8, 16)), dim=8, d_tile=4,
                                      quantized=False)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grain", ["lane", "partition"])
def test_first_vote_blocks_counts_the_plain_walks_survivors(dtype, grain):
    """``chip_smoke.first_vote_blocks`` (blocks alive after their first
    d-tile, whose look-ahead copies the bulk body may waste) at one lane a
    block is the plain walk's lanes alive entering tile 1, and at a whole
    partition a block its partitions alive entering tile 1."""
    store, m = _mirror(3, 96, 130, dtype, seed=5)
    ids = _stage_ids(store, 3)
    q = torch.from_numpy(np.random.default_rng(6).standard_normal(96).astype(np.float32))
    sc, off = (m.scale, m.offset) if m.quantized else (None, None)
    full, _ = tref.pdx_prune_scan_multi_ref(m.data, ids, q, float("inf"), d_tile=16, eps0=2.1,
                                            scale=sc, offset=off, packed=m.packed, dim=m.dim)
    thr = torch.sort(full[ids >= 0]).values[40]
    _, _, walk = tref.pdx_prune_scan_multi_ref(m.data, ids, q, thr, d_tile=16, eps0=2.1,
                                               scale=sc, offset=off, packed=m.packed,
                                               dim=m.dim, trace=True)
    lanes, want = (1, walk.lanes[1]) if grain == "lane" else (130, walk.parts[1])
    got = _chip_smoke().first_vote_blocks(torch, tref, m, ids, q, thr, 2.1, 16, lanes)
    assert 0 < got == int(want)
