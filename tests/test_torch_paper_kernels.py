"""The port's four paper-kernel ops on the CPU (their plain PyTorch
versions) vs the reference's ops running the Pallas kernels in interpret
mode, on every case of ``tests/test_kernels.py``'s sweeps: K4
``pdx_distance_op``, K5 ``nary_distance_op``, K7 ``batched_distance_op``
and K6 ``pdx_prune_scan_op``.  Inputs come from one numpy seed per case and
reach both sides as the same values (bf16 ones as the same bf16 values).

Tolerances are the reference test's own: f32 rtol 2e-5 / atol 1e-4, bf16
rtol 2e-2 / atol 2e-1 (K4, K5; the Pallas body sums by d-tile, the plain
body in one reduction); K7 f32 rtol 1e-4 / atol 1e-3 and bf16 rtol 3e-2 /
atol 5e-1 (the cancelling l2 form); K6 dists rtol 1e-4 / atol 1e-4 and
alive masks equal, PAD lanes from ``ids``, thr 0 and thr +inf included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(8, 64), (96, 128), (128, 1000), (384, 96), (33, 130)]
DTYPES = ("f32", "bf16")
F32_TOL = dict(rtol=2e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor, in ``dtype``."""
    if dtype == "bf16":
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _tol(dtype: str) -> dict:
    return BF16_TOL if dtype == "bf16" else F32_TOL


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
@pytest.mark.parametrize("D,V", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pdx_distance_op_matches_reference(metric, D, V, dtype):
    rng = np.random.default_rng(D * 1000 + V)
    Tj, Tt = _pair(rng.standard_normal((D, V)), dtype)
    qj, qt = _pair(rng.standard_normal(D), dtype)
    got = tops.pdx_distance_op(Tt, qt, metric)
    assert got.dtype == torch.float32 and got.shape == (V,)
    want = jops.pdx_distance_op(Tj, qj, metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
@pytest.mark.parametrize("N,D", [(64, 8), (1000, 128), (130, 33)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_nary_distance_op_matches_reference(metric, N, D, dtype):
    rng = np.random.default_rng(N * 1000 + D)
    Xj, Xt = _pair(rng.standard_normal((N, D)), dtype)
    qj, qt = _pair(rng.standard_normal(D), dtype)
    got = tops.nary_distance_op(Xt, qt, metric)
    assert got.dtype == torch.float32 and got.shape == (N,)
    want = jops.nary_distance_op(Xj, qj, metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dtype))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,D,V", [(4, 32, 64), (16, 128, 256), (3, 50, 130)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_distance_op_matches_reference(metric, B, D, V, dtype):
    rng = np.random.default_rng(B * 100_000 + D * 1000 + V)
    Tj, Tt = _pair(rng.standard_normal((D, V)), dtype)
    Qj, Qt = _pair(rng.standard_normal((B, D)), dtype)
    got = tops.batched_distance_op(Tt, Qt, metric)
    assert got.dtype == torch.float32 and got.shape == (B, V)
    want = jops.batched_distance_op(Tj, Qj, metric)
    tol = dict(rtol=3e-2, atol=5e-1) if dtype == "bf16" else dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _scan_case(D, V, seed):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((D, V)).astype(np.float32)
    q = rng.standard_normal(D).astype(np.float32)
    full = ((T - q[:, None]) ** 2).sum(0)
    return T, q, np.float32(np.partition(full, 10)[10])


def _both_scans(T, q, thr, ids=None, **kw):
    """(port dists, port alive, reference dists, reference alive), numpy."""
    td, ta = tops.pdx_prune_scan_op(torch.from_numpy(T), torch.from_numpy(q),
                                    torch.tensor(thr),
                                    None if ids is None else torch.from_numpy(ids), **kw)
    jd, ja = jops.pdx_prune_scan_op(jnp.asarray(T), jnp.asarray(q), jnp.float32(thr),
                                    None if ids is None else jnp.asarray(ids), **kw)
    assert ta.dtype == torch.bool and td.dtype == torch.float32
    return td.numpy(), ta.numpy(), np.asarray(jd), np.asarray(ja)


@pytest.mark.parametrize("D,V", [(64, 128), (128, 256), (96, 1000)])
@pytest.mark.parametrize("d_tile", [16, 32, 64])
def test_prune_scan_op_matches_reference(D, V, d_tile):
    """The reference test's sweep: thr at the 11th smallest distance, so
    lanes die at every d-tile; D = 96 at d_tile 64 ends on a clipped tile."""
    T, q, thr = _scan_case(D, V, D + V + d_tile)
    td, ta, jd, ja = _both_scans(T, q, thr, eps0=2.1, d_tile=d_tile)
    np.testing.assert_array_equal(ta, ja)
    assert 0 < ta.sum() < V
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("thr", ["k11", "zero", "inf"])
@pytest.mark.parametrize("D,V,d_tile", [(64, 130, 64), (33, 130, 16), (200, 1000, 64)])
def test_prune_scan_op_pad_lanes_and_thresholds(D, V, d_tile, thr):
    """PAD lanes (``ids < 0``) start dead on both sides, at any threshold;
    at thr 0 every lane dies at the first tile, at +inf every real lane
    lives with its full distance."""
    T, q, k11 = _scan_case(D, V, 7 * D + V)
    t = {"k11": k11, "zero": np.float32(0.0), "inf": np.float32(np.inf)}[thr]
    ids = np.arange(V, dtype=np.int32)
    ids[[0, 5, V // 2]] = -1
    ids[-3:] = -1
    td, ta, jd, ja = _both_scans(T, q, t, ids, eps0=2.1, d_tile=d_tile)
    np.testing.assert_array_equal(ta, ja)
    assert not ta[ids < 0].any()
    real = ids >= 0
    np.testing.assert_allclose(td[real], jd[real], rtol=1e-4, atol=1e-4)
    if thr == "inf":
        assert ta[real].all()
        np.testing.assert_allclose(td[real], ((T - q[:, None]) ** 2).sum(0)[real],
                                   rtol=1e-4, atol=1e-4)
    if thr == "zero":
        assert not ta.any()


def test_prune_scan_ref_trace_counts_lanes_entering_each_tile():
    """``trace=True`` returns the lanes alive entering each d-tile (what the
    kernel's bound counts): all real lanes first, then non-increasing, and
    the last count at least the survivors."""
    T, q, thr = _scan_case(130, 500, 3)
    ids = torch.arange(500, dtype=torch.int32)
    ids[:20] = -1
    d, a, walk = tref.pdx_prune_scan_ref(torch.from_numpy(T), torch.from_numpy(q), thr,
                                        d_tile=32, eps0=2.1, ids=ids, trace=True)
    lanes = walk.lanes.tolist()
    assert len(lanes) == 5 and lanes[0] == 480
    assert all(a_ >= b_ for a_, b_ in zip(lanes, lanes[1:]))
    assert lanes[-1] >= float(a.sum()) > 0
    d2, a2 = tref.pdx_prune_scan_ref(torch.from_numpy(T), torch.from_numpy(q), thr,
                                     d_tile=32, eps0=2.1, ids=ids)
    assert torch.equal(d, d2) and torch.equal(a, a2)


@pytest.mark.parametrize("dtype,per_sector", [("f32", 8), ("bf16", 16)])
def test_prune_scan_ref_trace_counts_live_sectors(dtype, per_sector):
    """``trace=True``'s ``sectors`` (K6's sector-level bound): per d-tile,
    the 32-byte sectors of a row (runs of 8 f32 or 16 bf16 lanes from lane
    0, the last one short: V = 203) holding a lane alive entering the
    tile, against a NumPy walk; PAD lanes never count."""
    D, V, d_tile = 96, 203, 32
    T, q, k11 = _scan_case(D, V, 9)
    thr = k11 * np.float32(0.6)  # most lanes die at the first two tiles
    ids = np.arange(V, dtype=np.int32)
    ids[[0, 3, 17, 100]] = -1
    ids[-5:] = -1
    Tt = torch.from_numpy(T).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    _, _, walk = tref.pdx_prune_scan_ref(Tt, torch.from_numpy(q), thr, d_tile=d_tile,
                                        eps0=2.1, ids=torch.from_numpy(ids), trace=True)
    # no lane within 1e-3 of its bound: NumPy's sum order decides every lane alike
    assert float(walk.margin[ids >= 0].min()) > 1e-3
    X = Tt.to(torch.float32).numpy()
    alive = ids >= 0
    acc = np.zeros(V, np.float32)
    want_sectors, want_lanes = [], []
    for lo in range(0, D, d_tile):
        hi = min(lo + d_tile, D)
        padded = np.zeros(-(-V // per_sector) * per_sector, dtype=bool)
        padded[:V] = alive
        want_sectors.append(int(padded.reshape(-1, per_sector).any(axis=1).sum()))
        want_lanes.append(int(alive.sum()))
        acc = np.where(alive, acc + ((X[lo:hi] - q[lo:hi, None]) ** 2).sum(0), acc)
        s = np.float32(1) + np.float32(2.1) / np.sqrt(np.float32(hi))
        alive = alive & (acc * (np.float32(D) / np.float32(hi)) <= thr * (s * s))
    assert walk.lanes.tolist() == want_lanes
    assert walk.sectors.tolist() == want_sectors
    # lanes die at each tile; a sector lives while any of its lanes does
    assert want_lanes[0] > want_lanes[1] > want_lanes[2] > 0
    assert want_sectors[0] > want_sectors[2] > 0
    assert want_sectors[1] > want_lanes[1] / per_sector


# The reference's three property tests of the prune scan, on the port.
def test_prune_scan_never_prunes_nearest():
    """Survivors must include the true nearest neighbour at sane eps0."""
    rng = np.random.default_rng(1234)
    D, V = 128, 512
    T = torch.from_numpy(rng.standard_normal((D, V)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    full = tref.pdx_distance_ref(T, q).numpy()
    thr = np.float32(np.partition(full, 10)[10])
    _, alive = tops.pdx_prune_scan_op(T, q, thr, eps0=2.1)
    assert bool(alive[int(np.argmin(full))])


def test_prune_scan_all_pruned_when_thr_zero():
    rng = np.random.default_rng(1235)
    D, V = 64, 256
    T = torch.from_numpy((rng.standard_normal((D, V)) + 10.0).astype(np.float32))
    q = torch.zeros(D)
    _, alive = tops.pdx_prune_scan_op(T, q, np.float32(1e-3))
    assert int(alive.sum()) == 0


def test_prune_scan_returns_bool_and_masks_pad_lanes():
    """alive is a bool mask, and lanes whose ids are -1 (PAD columns) never
    surface, even at an infinite threshold that keeps every other lane."""
    rng = np.random.default_rng(1236)
    D, V = 64, 130
    T = torch.from_numpy(rng.standard_normal((D, V)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    ids = np.arange(V, dtype=np.int32)
    ids[5] = -1
    ids[-3:] = -1
    _, alive = tops.pdx_prune_scan_op(T, q, np.float32(np.inf), torch.from_numpy(ids))
    assert alive.dtype == torch.bool
    alive = alive.numpy()
    assert not alive[ids < 0].any()
    assert alive[ids >= 0].all()


@pytest.mark.parametrize("op,args", [
    ("pdx_distance_op", ((8, 16), (8,), "cosine")),
    ("nary_distance_op", ((16, 8), (8,), "cosine")),
    ("batched_distance_op", ((8, 16), (2, 8), "l1")),
])
def test_ops_refuse_a_metric_their_kernel_lacks(op, args):
    a, b, metric = args
    with pytest.raises(ValueError, match="metric"):
        getattr(tops, op)(torch.zeros(a), torch.zeros(b), metric)
