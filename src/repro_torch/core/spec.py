"""Declarative search specification — *what* to search, not *how*.

Counterpart of ``repro.core.spec``.  A ``SearchSpec`` captures the
strategy-level knobs once; the planner (``repro_torch.core.plan``) maps a
``(spec, store, query shape)`` onto an executor.  Specs are frozen
(hashable, reusable across queries and engines) and validated at
construction.

One intended divergence from the reference: ``KERNELS`` is
``("auto", "cuda", "torch")``, the counterparts of the reference's
``("auto", "pallas", "jnp")``.  The value steers *planning* only: "cuda"
forces the fused executors, "auto" picks them when the store lives on a
CUDA device, "torch" keeps the plain executors.  Which body a fused
executor runs is set by the tensors' device — the hand-written CUDA
kernels for CUDA tensors, their plain PyTorch versions for CPU tensors —
and never by this knob, so the card's path cannot fall back to the plain
version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .distance import METRICS
from .layout import SCAN_DTYPES
from .pdxearch import SearchStats

__all__ = ["SearchSpec", "SearchResult", "parse_cascade_stage"]

SCHEDULES = ("adaptive", "fixed")
ROUTINGS = ("broadcast", "bucket")
KERNELS = ("auto", "cuda", "torch")
# Full-dimension dtypes a cascade may run between the (optional) projection
# stage and the mandatory exact "f32" re-rank terminator.
CASCADE_MID_DTYPES = ("bf16", "int8", "int4")


def parse_cascade_stage(stage: str) -> tuple[str, str, int]:
    """One cascade stage string -> (kind, dtype, rank).

    Stage grammar:
      "projN"         — rank-N learned-projection scan, f32 mirror
      "projN:dtype"   — rank-N projection scan at a quantized mirror dtype
      "bf16"|"int8"|"int4" — full-dimension scan at that mirror dtype
      "f32"           — the exact full-precision re-rank (always last)

    Returns ``kind`` in ("proj", "scan", "exact"); ``rank`` is 0 except for
    projection stages.  Raises ValueError on anything else.
    """
    if stage == "f32":
        return ("exact", "f32", 0)
    if stage in CASCADE_MID_DTYPES:
        return ("scan", stage, 0)
    if stage.startswith("proj"):
        body = stage[4:]
        rank_s, _, dt = body.partition(":")
        dt = dt or "f32"
        if rank_s.isdigit() and int(rank_s) >= 1 and dt in SCAN_DTYPES:
            return ("proj", dt, int(rank_s))
    raise ValueError(
        f"bad cascade stage {stage!r}: expected 'projN[:dtype]', one of "
        f"{CASCADE_MID_DTYPES}, or the final 'f32'"
    )


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Declarative description of one vector-similarity search.

    Result shaping
      k          — neighbours to return per query.
      metric     — "l2" | "l1" | "ip" (all minimized; ip is negated).

    Pruning configuration (PDXearch phases; see ``core.pdxearch``)
      schedule   — boundary schedule: "adaptive" (exponential steps, the
                   paper's fix for fixed-Δd tail latency) or "fixed".
      delta_d    — step size for the "fixed" schedule.
      sel_frac   — surviving fraction below which the PRUNE phase compacts
                   survivors (paper: 0.2).
      group      — partitions evaluated per pruning round (host path).

    IVF routing
      nprobe     — buckets probed when the engine has an IVF index.
      routing    — distributed query routing on a mesh; meshes are not
                   ported yet, so the knob is inert here.

    Device-scan precision (the bandwidth lever; see ``core.layout``'s
    dtype-policy block)
      scan_dtype  — operand precision of the device scan: "f32" streams the
                    master tiles; "bf16"/"int8" stream the quantized device
                    mirror (2x/4x fewer bytes per dimension value) and the
                    executor re-ranks the top ``rerank_mult * k`` candidates
                    against the f32 masters, so *returned distances stay
                    exact*.
      kernel      — planning knob: "cuda" forces the fused executors (a
                    CPU store then raises), "torch" keeps the plain
                    executors (a fused executor on a CUDA store then
                    raises), "auto" picks the fused executors when the
                    store lives on CUDA.  The tensors' device picks the
                    body: CUDA kernels on the card, plain torch on the
                    CPU.
      rerank_mult — exact-re-rank candidate multiplier (top ``rerank_mult *
                    k`` approximate candidates are re-scored in f32 when
                    ``scan_dtype != "f32"``).
      cascade     — multi-resolution scan pipeline, e.g.
                    ``("proj32:int4", "int8", "f32")``; validated as the
                    reference validates it, but its executors are not
                    ported yet (the planner raises NotImplementedError).
      route_dtype — precision of the IVF centroid routing scan ("f32"
                    default; "int8"/"int4" scan a quantized centroid
                    mirror).  Near-tie bucket *order* may differ from f32
                    routing at partial nprobe.
      hbm_slots   — tiered serving over a bucket cache; not ported yet
                    (the planner raises NotImplementedError on an IVF
                    engine).

    Execution hints (planner inputs, never change *results* beyond the
    pruner's own approximation)
      executor          — force a registered executor by name (see
                          ``core.plan.executor_names()``); None lets
                          the planner choose.
      prefer_static     — prefer the shape-static masked path
                          (``jit-masked``; not ported yet).
      batch_collectives — mesh knob; inert here.
    """

    k: int = 10
    metric: str = "l2"
    schedule: str = "adaptive"
    delta_d: int = 32
    sel_frac: float = 0.2
    group: int = 8
    nprobe: int = 8
    executor: Optional[str] = None
    prefer_static: bool = False
    batch_collectives: bool = True
    routing: str = "bucket"
    scan_dtype: str = "f32"
    kernel: str = "auto"
    rerank_mult: int = 4
    cascade: Optional[tuple] = None
    route_dtype: str = "f32"
    hbm_slots: Optional[int] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, got {self.metric!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {self.schedule!r}"
            )
        if self.delta_d < 1:
            raise ValueError(f"delta_d must be >= 1, got {self.delta_d}")
        if not (0.0 < self.sel_frac <= 1.0):
            raise ValueError(f"sel_frac must be in (0, 1], got {self.sel_frac}")
        if self.group < 1:
            raise ValueError(f"group must be >= 1, got {self.group}")
        if self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {self.nprobe}")
        if self.routing not in ROUTINGS:
            raise ValueError(
                f"routing must be one of {ROUTINGS}, got {self.routing!r}"
            )
        if self.scan_dtype not in SCAN_DTYPES:
            raise ValueError(
                f"scan_dtype must be one of {SCAN_DTYPES}, "
                f"got {self.scan_dtype!r}"
            )
        if self.kernel not in KERNELS:
            raise ValueError(
                f"kernel must be one of {KERNELS}, got {self.kernel!r}"
            )
        if self.rerank_mult < 1:
            raise ValueError(
                f"rerank_mult must be >= 1, got {self.rerank_mult}"
            )
        if self.route_dtype not in SCAN_DTYPES:
            raise ValueError(
                f"route_dtype must be one of {SCAN_DTYPES}, "
                f"got {self.route_dtype!r}"
            )
        if self.hbm_slots is not None and self.hbm_slots < 1:
            raise ValueError(
                f"hbm_slots must be >= 1 when set, got {self.hbm_slots}"
            )
        if self.cascade is not None:
            stages = self.cascade
            if not (
                isinstance(stages, tuple)
                and len(stages) >= 2
                and all(isinstance(s, str) for s in stages)
            ):
                raise ValueError(
                    f"cascade must be a tuple of >= 2 stage strings, "
                    f"got {stages!r}"
                )
            if self.metric != "l2":
                raise ValueError(
                    "cascade scans are L2-only (the projection lower bound "
                    f"and the ADSampling test both assume it), got metric="
                    f"{self.metric!r}"
                )
            parsed = [parse_cascade_stage(s) for s in stages]  # may raise
            if parsed[-1][0] != "exact":
                raise ValueError(
                    f"cascade must end with the exact 'f32' re-rank, "
                    f"got {stages!r}"
                )
            for pos, (kind, _, _) in enumerate(parsed):
                if kind == "proj" and pos != 0:
                    raise ValueError(
                        f"a projection stage must come first, got {stages!r}"
                    )
                if kind == "exact" and pos != len(parsed) - 1:
                    raise ValueError(
                        f"'f32' is the terminal re-rank stage, got {stages!r}"
                    )
            if len(set(stages)) != len(stages):
                raise ValueError(f"duplicate cascade stages in {stages!r}")

    def replace(self, **changes) -> "SearchSpec":
        """A copy with ``changes`` applied (specs are immutable)."""
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class SearchResult:
    """Search output plus its provenance.

    ``ids``/``dists`` are (k,) for a single query, (B, k) for a batch.
    ``plan`` is the ``core.plan.ExecutionPlan`` the planner chose
    (executor name + reason + the store version searched), ``stats`` the
    work accounting when requested, and ``trace`` the per-query span record
    (``obs.trace.QueryTrace``) when observability is enabled.

    Unpacks like the legacy ``(ids, dists)`` tuple::

        ids, dists = engine.search(q, spec)
    """

    ids: np.ndarray
    dists: np.ndarray
    spec: SearchSpec
    plan: "ExecutionPlan"  # noqa: F821 — core.plan (no import cycle)
    stats: Optional[SearchStats] = None
    trace: Optional["QueryTrace"] = None  # noqa: F821 — obs.trace

    def __iter__(self):
        yield self.ids
        yield self.dists

    def __getitem__(self, i):
        return (self.ids, self.dists)[i]

    def __len__(self) -> int:
        return 2
