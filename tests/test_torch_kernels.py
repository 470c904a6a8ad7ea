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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import (
    batched_distance_quant_op as j_bmm,
    pdx_prune_scan_multi_op as j_scan,
)
from repro_torch.core import layout as tl
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import (
    batched_distance_quant_op as t_bmm,
    pdx_prune_scan_multi_op as t_scan,
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
