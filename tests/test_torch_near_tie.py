"""A near-tie case for the batched distance kernels K2/K7, and its checks
on the CPU.

``near_tie_case`` builds queries and PDX tile columns whose exact l2
distances come in pairs about 1e-6 apart (relative) and that plain TF32
orders the wrong way round: each query row ``b`` is nonzero on two dims
only, with values ``4k + 3`` and ``4k + 5`` (12 significant bits, both of
which TF32's 11 round to ``4k + 4``), and each of its column pairs swaps
two tile values on those dims (so TF32 sees no difference in the cross
term) while a dim no query reads lowers the second column's norm by 8:
exact gap +8, TF32 gap -8.  Every value, product and partial sum is an
integer below 2^24, so f32 arithmetic in any order is exact and the plain
f32 version orders every column as exact arithmetic does.  The tile is
built per mirror dtype: f32 values of 10 significant bits (they need all
three bf16 planes), bf16-exact values, or int8 levels with scale 2 and
offset 1.  ``tests/test_torch_cuda.py`` holds the kernel to the plain
version's order on this case; here the case itself is checked.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

NEAR_TIE_DTYPES = ("f32", "bf16", "int8")
_B, _D, _GROUPS = 64, 130, 4  # dims 128, 129: the norm dims no query reads


def near_tie_case(dtype: str):
    """-> (T (1, D, V) at the mirror dtype, Q (B, D) f32, scale, offset
    (None unless int8), pairs (B, G, 2) column indices: the first of each
    pair is nearer to its row's query by exact arithmetic)."""
    B, D, G = _B, _D, _GROUPS
    V = B * G * 2
    Q = np.zeros((B, D), np.float32)
    X = np.zeros((D, V), np.float32)  # the dequantized tile x^
    base = {"f32": (513, 601, 777, 1001), "bf16": (9, 21, 37, 101),
            "int8": (-119, -19, 11, 81)}[dtype]  # odd x^; int8: levels (x^ - 1) / 2
    pairs = np.zeros((B, G, 2), np.int64)
    for b in range(B):
        i, j = b, 64 + b
        qi = 2051 + 4 * (b % 8)
        Q[b, i], Q[b, j] = qi, qi + 2
        for g, t in enumerate(base):
            a, c = 2 * (b * G + g), 2 * (b * G + g) + 1
            X[i, a], X[j, a] = t, t + 4
            X[i, c], X[j, c] = t + 4, t  # swapped: cross term 8 lower
            X[128 + g % 2, a], X[128 + g % 2, c] = 3, 1  # norm 8 lower
            pairs[b, g] = (a, c)
    if dtype == "int8":
        scale = torch.full((D,), 2.0)
        offset = torch.full((D,), 1.0)
        # x^ = 2 l + 1 is odd: the entries left 0 above get level 0 (x^ = 1),
        # which adds the same 1s to both columns of a pair
        T = torch.from_numpy(np.where(X != 0, (X - 1) / 2, 0).astype(np.int8))[None]
        return T, torch.from_numpy(Q), scale, offset, torch.from_numpy(pairs)
    T = torch.from_numpy(X)[None]
    if dtype == "bf16":
        assert torch.equal(T.to(torch.bfloat16).float(), T)
        T = T.to(torch.bfloat16)
    return T, torch.from_numpy(Q), None, None, torch.from_numpy(pairs)


def exact_l2(T, Q, scale, offset) -> np.ndarray:
    """(B, V) l2 in float64 (exact here: integers below 2^53)."""
    x = ref.dequantize_ref(T[0], scale, offset).double().numpy()
    q = Q.double().numpy()
    return (q * q).sum(1)[:, None] - 2 * q @ x + (x * x).sum(0)[None, :]


def tf32(a: np.ndarray) -> np.ndarray:
    """f32 -> f32 rounded to TF32's 10 stored mantissa bits (nearest even)."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~np.uint64(0x1FFF)
    return b.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("dtype", NEAR_TIE_DTYPES)
def test_near_tie_case_is_exact_in_f32_and_flips_under_tf32(dtype):
    T, Q, sc, off, pairs = near_tie_case(dtype)
    exact = exact_l2(T, Q, sc, off)
    plain = ref.batched_distance_quant_ref(T[0], Q, sc, off, "l2")
    # f32 gets every distance exactly, hence the exact order
    np.testing.assert_array_equal(plain.double().numpy(), exact)
    a, c = pairs[..., 0].numpy(), pairs[..., 1].numpy()
    rows = np.arange(Q.shape[0])[:, None]
    gap = exact[rows, c] - exact[rows, a]
    assert np.all(gap == 8)
    rel = gap / exact[rows, a]
    assert 2e-7 < rel.min() and rel.max() < 5e-6
    # TF32 operands put the farther column of every pair first
    x = ref.dequantize_ref(T[0], sc, off).numpy()
    q = Q.numpy()
    cross = tf32(q).astype(np.float64) @ tf32(x).astype(np.float64)
    t32 = (q.astype(np.float64) ** 2).sum(1)[:, None] - 2 * cross + (
        x.astype(np.float64) ** 2).sum(0)[None, :]
    assert np.all(t32[rows, c] < t32[rows, a])


@pytest.mark.parametrize("dtype", NEAR_TIE_DTYPES)
def test_near_tie_case_split_is_exact(dtype):
    """The kernel's operands on this case: the query planes (the scale
    folded in at int8) sum exactly to the queries, and the split product
    plus ``q.o`` gives the exact distances in f32."""
    T, Q, sc, off, _ = near_tie_case(dtype)
    Qs, qo = ref.fold_scale(Q, sc, off) if sc is not None else (Q, None)
    planes = ref.split_bf16(Qs).float()
    want = Q * sc[None, :] if sc is not None else Q
    assert torch.equal((planes[0] + planes[1]) + planes[2], want)
    levels = T[0].float()
    cross = planes[2] @ levels + planes[1] @ levels + planes[0] @ levels
    if qo is not None:
        cross = cross + qo[:, None]
    x = ref.dequantize_ref(T[0], sc, off)
    got = (Q * Q).sum(1)[:, None] - 2 * cross + (x * x).sum(0)[None, :]
    np.testing.assert_array_equal(got.double().numpy(), exact_l2(T, Q, sc, off))
