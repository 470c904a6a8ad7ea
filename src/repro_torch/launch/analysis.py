"""Cost extraction for the dry-run (counterpart of ``repro.launch.analysis``).

The reference reads two things off XLA: the loop-aware cost of the step's
jaxpr (``jaxpr_cost``) and the collective bytes of the partitioned HLO
(``collective_bytes_hlo``).  The port has neither a jaxpr nor HLO; it runs
the step eagerly on meta tensors (shapes and dtypes, no storage) under a
``TorchDispatchMode`` and reads the ATen ops it issues.

* ``step_cost`` -- ``jaxpr_cost``'s counterpart: ``fn`` runs on
  *unsharded* meta tensors, the global program the reference's jaxpr is.
  Each op falls into the reference's classes: products (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot``, ``convolution``: what ``@``,
  ``einsum`` and ``F.linear`` become, and a pair of an ``einsum``'s
  operands that shares no contracted index, which ATen computes as a
  broadcast ``mul``) at 2 M N K into ``dot_flops``; the
  elementwise set (``_ELEMENTWISE``) at one FLOP an output element into
  ``ew_flops``; data movement and reductions into ``bytes`` (a reduction
  also adds its input's elements to ``ew_flops``).  An eager run has no
  loops to multiply: a Python loop over units or chunks issues each pass,
  and ``torch.utils.checkpoint``'s recompute happens in the backward pass
  and is counted there, as ``remat`` is in the differentiated jaxpr.  An
  SPMD per-rank body runs on its local shard and is multiplied by
  ``ranks``, the ranks that run it (the reference's ``shard_map`` branch).
  Views move no bytes in an eager program and are not counted.
* ``collective_bytes`` -- ``collective_bytes_hlo``'s counterpart: every
  collective a sharded step issues on its process group, those DTensor
  issues inside ``redistribute`` and sharding propagation
  (``_c10d_functional.*``) and those the port's own wrappers issue
  (``c10d.*``: ``dist.all_gather``, ``psum``, ``ppermute``), under the
  reference's kind names.  A collective's bytes are its result's bytes on
  this rank, as the HLO regex reads the result type.
* ``memory_trace`` -- the live-storage high-water mark of the same run
  (the dry-run's ``memory`` record, XLA's ``memory_analysis``): each op's
  new output storages stay live until freed; storages are counted, not
  tensors, so views and in-place writes add nothing.

The reference's HLO text parser (``_split_computations``, ``_shape_bytes``,
the while-trip regexes) reads XLA output and has no port: an eager run
issues each loop trip itself.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["step_cost", "collective_bytes", "memory_trace"]

# ==========================================================================
# Op classes (ATen overload-packet names; an in-place form drops its "_").
# ==========================================================================
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "convolution"}

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "clamp",
    "clamp_min", "clamp_max", "exp", "log", "tanh", "sigmoid", "rsqrt",
    "sqrt", "abs", "neg", "sign", "floor", "pow", "where", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "erf", "cos", "sin", "reciprocal", "silu",
    "gelu", "softplus",
}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
               "cumsum", "logsumexp"}

_MOVEMENT = {
    "gather", "scatter", "scatter_add", "scatter_reduce", "index", "index_put",
    "index_select", "index_add", "index_copy", "embedding",
    "embedding_dense_backward", "cat", "stack", "_to_copy", "copy", "clone",
    "constant_pad_nd", "topk", "sort", "flip", "repeat", "slice_scatter",
    "select_scatter", "masked_fill", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "tril", "triu",
}

_COUNTED = _DOTS | _ELEMENTWISE | _REDUCTIONS | _MOVEMENT


def _tensors(tree) -> list:
    """The tensors of an op's arguments or result (a tensor, or a tuple or
    list of tensors, lists of them and other values)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        out = []
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (tuple, list, dict)):
                out += _tensors(x)
        return out
    if isinstance(tree, dict):
        return _tensors(list(tree.values()))
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


@functools.lru_cache(maxsize=None)
def _name(func) -> str:
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _dot_flops(name: str, args, out: torch.Tensor) -> float:
    if name == "convolution":  # 2 x out elements x (C_in / groups x kernel)
        w = args[1]
        return 2.0 * out.numel() * float(w[0].numel())
    # the contracted length: the last dim of the first matrix operand
    lhs = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.acc: dict[str, float] = defaultdict(float)
        self.by_op: dict[str, float] = defaultdict(float)
        self.in_einsum = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _name(func)
        if func.namespace != "aten" or name not in _COUNTED:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if name in _DOTS or (name == "mul" and self.in_einsum):
            if name in _DOTS:
                flops = _dot_flops(name, args, outs[0])
            else:  # a product of one term: 2 FLOPs an output element
                flops, name = 2.0 * outs[0].numel(), "einsum"
            self.acc["dot_flops"] += flops
            self.by_op[name] += flops
            self.acc["bytes"] += moved
        elif name in _ELEMENTWISE:
            self.acc["ew_flops"] += float(outs[0].numel()) if outs else 0.0
            self.acc["bytes"] += moved
        elif name in _REDUCTIONS:
            self.acc["ew_flops"] += float(ins[0].numel()) if ins else 0.0
            self.acc["bytes"] += moved
        elif name in _MOVEMENT:
            self.acc["bytes"] += moved
        return out


@contextlib.contextmanager
def _einsum_products(cost: _CostMode):
    """A ``mul`` that ``torch.einsum`` issues multiplies two operands that
    share no contracted index (an outer product, or the first pair of a
    three-operand einsum), where the reference's ``dot_general`` counts a
    product of one term, 2 FLOPs an output element: ``cost`` counts it as
    the reference does.  ``torch.einsum`` is wrapped for the run, not
    intercepted by a ``TorchFunctionMode``: no such mode is active in the
    backward pass, where a checkpoint recomputes its unit."""
    real = torch.einsum

    def einsum(*args, **kwargs):
        cost.in_einsum = True
        try:
            return real(*args, **kwargs)
        finally:
            cost.in_einsum = False

    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = real


def step_cost(fn: Callable, *args, ranks: int = 1, **kwargs) -> dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` (meta tensors: nothing is allocated) ->
    ``{"flops", "dot_flops", "ew_flops", "bytes"}`` of its ATen ops, times
    ``ranks`` (an SPMD body on one rank's shard: the ranks that run it),
    and ``dot_flops_by_op``, the products' FLOPs by ATen op."""
    mode = _CostMode()
    with mode, _einsum_products(mode):
        fn(*args, **kwargs)
    out: dict[str, Any] = {k: v * ranks for k, v in mode.acc.items()}
    for k in ("dot_flops", "ew_flops", "bytes"):
        out.setdefault(k, 0.0)
    out["flops"] = out["dot_flops"] + out["ew_flops"]
    out["dot_flops_by_op"] = {k: v * ranks for k, v in mode.by_op.items()}
    return out


# ==========================================================================
# Collectives and live storages of a sharded run.
# ==========================================================================
_FUNCOL = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")

# (name fragment, the reference's HLO kind), first match wins
_KINDS = (
    ("reduce_scatter", "reduce-scatter"),
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("recv", "collective-permute"),
    ("broadcast", "broadcast"),
)


@functools.lru_cache(maxsize=None)
def _kind(func) -> str | None:
    if func.namespace not in _FUNCOL and func.namespace != "c10d":
        return None
    name = func._overloadpacket.__name__
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


class _Trace(TorchDispatchMode):
    """Sees the local ops under DTensor (it returns ``NotImplemented`` to a
    DTensor op, which then runs its local ops and collectives through this
    mode again): collectives by kind, and the live output storages."""

    def __init__(self, live_bytes: float = 0.0, known=()):
        super().__init__()
        self.bytes: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)
        self.live = self.peak = live_bytes
        self._seen: set[int] = set(known)  # ids of live storages
        self._refs: dict[int, weakref.ref] = {}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        n = float(st.nbytes())
        self.live += n
        self.peak = max(self.peak, self.live)
        self._refs[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))

    def _free(self, key: int, n: float) -> None:
        self._seen.discard(key)
        self._refs.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _kind(func)
        if kind is not None:
            # the c10d ops write into their first argument; funcol returns
            res = _tensors(out) if func.namespace in _FUNCOL else _tensors(args[0])
            self.bytes[kind] += sum(map(_nbytes, res))
            self.count[kind] += 1
        for t in _tensors(out):
            # DTensor's sharding propagation runs each op once more on fake
            # global-shape tensors: metadata, no rank's memory
            if not isinstance(t, (DTensor, FakeTensor)):
                self._track(t)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _storages(tree) -> dict[int, float]:
    """{id of storage: bytes} of the (local) tensors in ``tree``."""
    out = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        out[id(st)] = float(st.nbytes())
    return out


def collective_bytes(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` -> ``{"bytes": {kind: B}, "count":
    {kind: n}, "total": B}`` of the collectives it issues on this rank
    (kinds: all-reduce, all-gather, reduce-scatter, all-to-all,
    collective-permute)."""
    return memory_trace(fn, *args, **kwargs)[1]


def memory_trace(fn: Callable, *args, **kwargs) -> tuple[Any, dict, dict]:
    """Run ``fn(*args, **kwargs)`` once -> (its result, the collectives as
    ``collective_bytes`` gives them, the memory record on this rank):
    ``argument_size_in_bytes`` (the storages of ``args``),
    ``output_size_in_bytes`` (the result's storages that are not an
    argument's), ``peak_memory_in_bytes`` (the high-water mark of live
    storages, arguments included) and ``temp_size_in_bytes`` (that peak
    less the arguments and the outputs, as XLA splits it)."""
    held = _storages(args)
    mode = _Trace(sum(held.values()), held)
    with mode:
        out = fn(*args, **kwargs)
    outs = {k: v for k, v in _storages(out).items() if k not in held}
    arg_b, out_b = sum(held.values()), sum(outs.values())
    coll = {"bytes": dict(mode.bytes), "count": dict(mode.count),
            "total": float(sum(mode.bytes.values()))}
    mem = {"argument_size_in_bytes": int(arg_b), "output_size_in_bytes": int(out_b),
           "peak_memory_in_bytes": int(mode.peak),
           "temp_size_in_bytes": int(max(mode.peak - arg_b - out_b, 0))}
    return out, coll, mem
