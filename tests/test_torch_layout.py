"""repro_torch.core.layout vs repro.core.layout on the CPU.

The store builders and the quantized mirrors are host NumPy plus f32
elementwise arithmetic, so the port must reproduce the reference bit for
bit: tile data, ids, counts and int levels are compared exactly; the
dequantization scale/offset to rtol 1e-6 (one f32 division each, where a
reassociated max could only move the last bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as jl
from repro.data.synthetic import make_dataset
from repro_torch.core import layout as tl

DTYPES = ("f32", "bf16", "int8", "int4")


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _stores(kind):
    """(reference store, port store) built from the same rows: a flat store
    at 1900 x 50 with PAD lanes (1900 % 256 != 0), or an 8-bucket IVF
    layout at 2048 x 32 with odd-sized buckets."""
    if kind == "flat":
        X, _ = make_dataset(1900, 50, "normal", n_queries=1, seed=7)
        return (jl.build_flat_store(X, capacity=256),
                tl.build_flat_store(X, capacity=256, device="cpu"))
    X, _ = make_dataset(2048, 33, "skewed", n_queries=1, seed=4)
    a = np.random.default_rng(0).integers(0, 8, size=len(X))
    a[a == 5] = 6  # an empty bucket emits zero partitions
    js, jo, jn = jl.build_bucketed_store(X, a, 8, 128)
    ts, to, tn = tl.build_bucketed_store(X, a, 8, 128, device="cpu")
    np.testing.assert_array_equal(jo, to)
    np.testing.assert_array_equal(jn, tn)
    return js, ts


@pytest.mark.parametrize("kind", ["flat", "bucketed"])
def test_store_matches_reference_bitwise(kind):
    js, ts = _stores(kind)
    for name in ("data", "ids", "counts", "dim_means", "dim_vars"):
        np.testing.assert_array_equal(_np(getattr(js, name)), _np(getattr(ts, name)), name)
    assert ts.num_vectors == js.num_vectors
    np.testing.assert_array_equal(jl.pdx_to_nary(js), tl.pdx_to_nary(ts))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["flat", "bucketed"])
def test_mirrors_match_reference(kind, dtype):
    js, ts = _stores(kind)
    jm, tm = jl.device_mirror(js, dtype), tl.device_mirror(ts, dtype)
    assert (tm.dim, tm.packed, tm.quantized, tm.bytes_per_value) == (
        jm.dim, jm.packed, jm.quantized, jm.bytes_per_value)
    np.testing.assert_array_equal(_np(jm.data), _np(tm.data))
    np.testing.assert_allclose(_np(jm.scale), _np(tm.scale), rtol=1e-6)
    np.testing.assert_allclose(_np(jm.offset), _np(tm.offset), rtol=1e-6)
    assert tl.device_mirror(ts, dtype) is tm  # cached per (dtype, version)


@pytest.mark.parametrize("D", [7, 8])
def test_unpack_int4_matches_reference(D):
    X, _ = make_dataset(300, D, "normal", n_queries=1, seed=2)
    ts = tl.build_flat_store(X, capacity=128, device="cpu")
    m = tl.device_mirror(ts, "int4")
    got = tl.unpack_int4(m.data, dim_axis=1, dim=D)
    want = jl.unpack_int4(jnp.asarray(m.data.numpy()), dim_axis=1, dim=D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.abs().max() <= 7


def test_empty_collection_gets_one_pad_partition():
    X = np.zeros((0, 4), np.float32)
    js, _, _ = jl.build_bucketed_store(X, np.zeros(0, np.int64), 3, 64)
    ts, _, _ = tl.build_bucketed_store(X, np.zeros(0, np.int64), 3, 64, device="cpu")
    assert ts.num_partitions == js.num_partitions == 1
    assert ts.num_vectors == 0 and bool((ts.ids < 0).all())


def test_mirror_rejects_unknown_dtype():
    _, ts = _stores("flat")
    with pytest.raises(ValueError, match="scan dtype"):
        tl.device_mirror(ts, "fp64")
