"""K1, K3, K4 and K6 — the PDX scans, hand-written in CUDA for Hopper.

All bind ``csrc/pdx_scan.cu``:

  ``pdx_prune_scan_multi_cuda`` (K1, replacing the TPU kernel
  ``repro.kernels.pdx_scan.pdx_prune_scan_multi_pallas``): one launch scans
  every partition of a mirror with the ADSampling test fused per d-tile.
  Its launch shape (``pdx_prune_scan_multi_geometry``, K3's too) follows
  the mirror: the bulk body, fed by tensor copies (TMA) into a ring in
  shared memory, wherever its row segments are 16-byte aligned, else the
  direct body.

  ``pdx_prune_scan_multi_prefetch_cuda`` (K3, replacing
  ``pdx_prune_scan_multi_prefetch_pallas``): the same scan for the later
  cascade stages; a partition that enters dead fetches nothing, and the
  launch also returns ``streamed``, the d-tiles each partition fetched.

  ``pdx_distance_cuda`` (K4, replacing ``pdx_distance_pallas``): the
  paper's PDX kernel, a plain (D, V) distance scan (l2, ip, l1), each
  thread streaming its lanes down the rows with many loads in flight.

  ``pdx_prune_scan_cuda`` (K6, replacing ``pdx_prune_scan_pallas``): one
  (D, V) partition's fused L2 scan with the ADSampling test per d-tile,
  as two launches: a sweep of d-tile 0 over every lane (K4's streaming
  body) that appends the survivors to a list in a workspace
  (``pdx_prune_scan_workspace``), then a persistent tail over the list
  whose warps gather only live lanes, a whole d-tile in flight
  (``pdx_prune_scan_geometry`` gives the launch shape).

Callers go through ``kernels.ops``, which pads operands and dispatches by
device; these wrappers take CUDA tensors only and raise on anything else.
Each counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import bind, check_launch

__all__ = [
    "pdx_prune_scan_multi_cuda",
    "pdx_prune_scan_multi_prefetch_cuda",
    "pdx_prune_scan_multi_geometry",
    "pdx_distance_cuda",
    "pdx_prune_scan_cuda",
    "pdx_prune_scan_workspace",
    "pdx_prune_scan_geometry",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}
#: the metrics of the plain distance kernels (K4, K5), by their code
METRIC_CODES = {"l2": 0, "ip": 1, "l1": 2}


def _check(t: torch.Tensor, name: str, dtype=None, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, T, ids, q, thr, scale, offset, outputs, dim, d_tile,
            eps0, quantized) -> None:
    """Check the operands, then launch ``name`` writing ``outputs``."""
    if T.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported mirror dtype {T.dtype}")
    packed = T.dtype == torch.uint8
    P, Drows, V = T.shape
    Dlog = 2 * Drows if packed else Drows
    if packed and d_tile % 2:
        raise ValueError(f"packed scan needs an even d_tile, got {d_tile}")
    if not (0 < dim <= Dlog and d_tile > 0):
        raise ValueError(f"bad dim={dim} / d_tile={d_tile} for {Dlog} stored dims")
    _check(T, "T")
    _check(ids, "ids", torch.int32, (P, V))
    for vname, t in (("q", q), ("scale", scale), ("offset", offset)):
        _check(t, vname, torch.float32, (Dlog,))
    _check(thr, "thr", torch.float32, (1,))
    fn = bind("pdx_scan", name, "pippppp" + "p" * len(outputs) + "iiiiifip")
    rc = fn(
        T.data_ptr(), _DTYPE_CODES[T.dtype], ids.data_ptr(), q.data_ptr(),
        thr.data_ptr(), scale.data_ptr(), offset.data_ptr(),
        *(o.data_ptr() for o in outputs), P, Drows, V, dim, d_tile,
        float(eps0), int(quantized or packed),
        torch.cuda.current_stream(T.device).cuda_stream,
    )
    check_launch("pdx_scan", name, rc)


def pdx_prune_scan_multi_cuda(
    T: torch.Tensor,
    ids: torch.Tensor,
    q: torch.Tensor,
    thr: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    *,
    dim: int,
    d_tile: int,
    eps0: float,
    quantized: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, Drows, V) mirror tiles (uint8 = packed int4), (P, V) int32 ids,
    (Dlog,) f32 q/scale/offset (Dlog = Drows, or 2*Drows when packed),
    (1,) f32 thr on the device -> (dists (P, V) f32, alive (P, V) bool).
    ``dim`` is the logical dimension count the test divides by."""
    P, _, V = T.shape
    dists = torch.empty((P, V), dtype=torch.float32, device=T.device)
    alive = torch.empty((P, V), dtype=torch.bool, device=T.device)
    _launch("pdx_prune_scan_multi", T, ids, q, thr, scale, offset,
            (dists, alive), dim, d_tile, eps0, quantized)
    pdx_prune_scan_multi_cuda.launches += 1
    return dists, alive


def pdx_prune_scan_multi_prefetch_cuda(
    T: torch.Tensor,
    ids: torch.Tensor,
    q: torch.Tensor,
    thr: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    *,
    dim: int,
    d_tile: int,
    eps0: float,
    quantized: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's operands -> (dists (P, V) f32, alive (P, V) bool, streamed (P,)
    f32).  A partition with no lane ``ids >= 0`` reads nothing more and
    reports dist 0, alive false and streamed 0."""
    P, _, V = T.shape
    dists = torch.empty((P, V), dtype=torch.float32, device=T.device)
    alive = torch.empty((P, V), dtype=torch.bool, device=T.device)
    streamed = torch.zeros((P,), dtype=torch.float32, device=T.device)
    _launch("pdx_prune_scan_multi_prefetch", T, ids, q, thr, scale, offset,
            (dists, alive, streamed), dim, d_tile, eps0, quantized)
    pdx_prune_scan_multi_prefetch_cuda.launches += 1
    return dists, alive, streamed


def pdx_prune_scan_multi_geometry(T: torch.Tensor, *, dim: int, d_tile: int, quantized: bool,
                                  prefetch: bool = False) -> dict:
    """The launch shape K1 (K3 with ``prefetch``) takes for the (P, Drows,
    V) mirror tiles ``T`` and the arguments its wrapper receives, from the
    library's own rule; launches nothing.  ``body`` is "bulk" where every
    row segment a block reads is 16-byte aligned, else "direct".  The bulk
    body launches a sweep of d-tile 0 over ``blocks`` blocks and, where
    there are more d-tiles, a tail of ``tail_blocks`` persistent blocks over
    the survivors; shared memory is per block, ``smem_bytes`` of the tail
    (or only) launch, ``smem_bytes_sweep`` of the sweep;
    ``lookahead_tiles`` is the d-tiles a tail block keeps requested ahead."""
    _check(T, "T")
    if T.dtype not in _DTYPE_CODES or T.ndim != 3:
        raise ValueError(f"T must be (P, Drows, V) mirror tiles, got {T.dtype} {tuple(T.shape)}")
    P, Drows, V = T.shape
    out = (ctypes.c_int * 7)()
    fn = bind("pdx_scan", "pdx_prune_scan_multi_geometry", "piiiiiiiip")
    rc = fn(T.data_ptr(), _DTYPE_CODES[T.dtype], P, Drows, V, dim, d_tile,
            int(quantized or T.dtype == torch.uint8), int(prefetch), ctypes.addressof(out))
    check_launch("pdx_scan", "pdx_prune_scan_multi_geometry", rc)
    return {"body": "bulk" if out[0] else "direct", "lanes_per_block": out[1],
            "blocks": out[2], "tail_blocks": out[6], "smem_bytes": out[3],
            "smem_bytes_sweep": out[5], "lookahead_tiles": out[4]}


def pdx_distance_cuda(T: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """(D, V) f32/bf16 tile, (D,) f32 query -> (V,) f32 distances: l2,
    l1 or negated ip."""
    if metric not in METRIC_CODES:
        raise ValueError(f"metric must be one of {tuple(METRIC_CODES)}, got {metric!r}")
    _check(T, "T")
    if T.dtype not in (torch.float32, torch.bfloat16) or T.ndim != 2:
        raise ValueError(f"T must be a (D, V) f32 or bf16 tile, got {T.dtype} {tuple(T.shape)}")
    D, V = T.shape
    _check(q, "q", torch.float32, (D,))
    out = torch.empty((V,), dtype=torch.float32, device=T.device)
    fn = bind("pdx_scan", "pdx_distance", "pippiiip")
    rc = fn(T.data_ptr(), _DTYPE_CODES[T.dtype], q.data_ptr(), out.data_ptr(), D, V,
            METRIC_CODES[metric], torch.cuda.current_stream(T.device).cuda_stream)
    check_launch("pdx_scan", "pdx_distance", rc)
    pdx_distance_cuda.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _workspace_bytes(V: int) -> int:
    n = bind("pdx_scan", "pdx_prune_scan_workspace_bytes", "i")(V)
    if n < 0:
        raise ValueError(f"a partition of {V} lanes is too wide for one launch")
    return n


def pdx_prune_scan_workspace(V: int, device) -> torch.Tensor:
    """K6's workspace for a partition of V lanes, int32 on ``device``.
    After a call: [0] the lanes alive after d-tile 0, [1] the tail's
    cursor, [2] the sweep's blocks done, [3:3 + nb + 1] the list's offsets
    (nb: ``pdx_prune_scan_geometry``'s ``sweep_blocks``; entry b the
    survivors before segment b), then the list: segment b, the survivors
    among the ``segment_lanes`` lanes from b * segment_lanes in lane order,
    at that index.  Its contents on entry do not matter."""
    return torch.empty(_workspace_bytes(V) // 4, dtype=torch.int32, device=device)


def pdx_prune_scan_geometry(T: torch.Tensor, *, d_tile: int) -> dict:
    """K6's launch shape for the (D, V) partition ``T`` at ``d_tile``, from
    the library's own rule; launches nothing.  ``body`` is "list": a sweep
    of d-tile 0 (``sweep_blocks`` blocks, ``lanes_per_thread`` lanes a
    thread) that appends the survivors to the workspace's list, then, where
    D spans more than one d-tile, a tail of ``tail_blocks`` blocks (one an
    SM) of ``tail_threads`` over the list, a lane gathering up to
    ``gather_rows`` rows at once; shared memory is per block.  A sweep
    block's ``segment_lanes`` lanes give one segment of the list."""
    _check(T, "T")
    if T.dtype not in (torch.float32, torch.bfloat16) or T.ndim != 2:
        raise ValueError(f"T must be a (D, V) f32 or bf16 tile, got {T.dtype} {tuple(T.shape)}")
    D, V = T.shape
    out = (ctypes.c_int * 8)()
    fn = bind("pdx_scan", "pdx_prune_scan_geometry", "iiiip")
    rc = fn(_DTYPE_CODES[T.dtype], D, V, d_tile, ctypes.addressof(out))
    check_launch("pdx_scan", "pdx_prune_scan_geometry", rc)
    return {"body": "list", "lanes_per_thread": out[0], "sweep_blocks": out[1],
            "tail_blocks": out[2], "tail_threads": out[3], "smem_bytes_sweep": out[4],
            "smem_bytes_tail": out[5], "gather_rows": out[6], "segment_lanes": out[7],
            "workspace_bytes": _workspace_bytes(V)}


def pdx_prune_scan_cuda(
    T: torch.Tensor,
    ids: Optional[torch.Tensor],
    q: torch.Tensor,
    thr: torch.Tensor,
    *,
    d_tile: int,
    eps0: float,
    workspace: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(D, V) f32/bf16 partition, (V,) int32 ids or None (every lane
    real), (D,) f32 query, (1,) f32 thr on the device -> (dists (V,) f32,
    alive (V,) bool).  The test divides by D: the operands are not padded,
    so every stored dimension is a logical one.  ``workspace``
    (``pdx_prune_scan_workspace(V, device)``) holds the survivor list; one
    is allocated where none is given."""
    _check(T, "T")
    if T.dtype not in (torch.float32, torch.bfloat16) or T.ndim != 2:
        raise ValueError(f"T must be a (D, V) f32 or bf16 tile, got {T.dtype} {tuple(T.shape)}")
    D, V = T.shape
    if d_tile <= 0:
        raise ValueError(f"d_tile must be positive, got {d_tile}")
    if ids is not None:
        _check(ids, "ids", torch.int32, (V,))
    _check(q, "q", torch.float32, (D,))
    _check(thr, "thr", torch.float32, (1,))
    n = _workspace_bytes(V) // 4
    if workspace is None:
        workspace = torch.empty(n, dtype=torch.int32, device=T.device)
    _check(workspace, "workspace", torch.int32)
    if workspace.numel() < n or workspace.device != T.device:
        raise ValueError(f"workspace must hold {n} int32 on {T.device}")
    dists = torch.empty((V,), dtype=torch.float32, device=T.device)
    alive = torch.empty((V,), dtype=torch.bool, device=T.device)
    fn = bind("pdx_scan", "pdx_prune_scan", "pippppppiiifp")
    rc = fn(T.data_ptr(), _DTYPE_CODES[T.dtype], None if ids is None else ids.data_ptr(),
            q.data_ptr(), thr.data_ptr(), dists.data_ptr(), alive.data_ptr(),
            workspace.data_ptr(), D, V, d_tile, float(eps0),
            torch.cuda.current_stream(T.device).cuda_stream)
    check_launch("pdx_scan", "pdx_prune_scan", rc)
    pdx_prune_scan_cuda.launches += 1
    return dists, alive


pdx_prune_scan_multi_cuda.launches = 0
pdx_prune_scan_multi_prefetch_cuda.launches = 0
pdx_distance_cuda.launches = 0
pdx_prune_scan_cuda.launches = 0
