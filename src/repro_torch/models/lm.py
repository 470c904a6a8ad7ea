"""Language-model assembly (counterpart of ``repro.models.lm``): layer specs
-> stacks of identical units -> the model.

A model is a sequence of *stacks*; each stack holds ``count`` identical
*units*; a unit is an ordered list of sub-blocks (pre-norm residual each).
The dense LM is one stack whose unit is ``[gqa, ffn]``, ``n_layers`` times.

Params are the reference's pytree as tensors: ``embed`` (V, d),
``final_norm``, ``lm_head`` (d, V) when the embeddings are untied, and
``stack{i}.sub{j}.{norm, wq, ...}`` with a leading unit axis.  Where the
reference scans a stack, the port loops over its units in Python; each
unit's params are views of the stacked tensors (``torch.unbind``, whose
backward stacks the units' gradients into the stacked leaf once).
Training recomputes each unit in the backward pass (``remat``,
``torch.utils.checkpoint``), and the loss is sequence-chunked
(``chunked_ce_loss``): it never holds (B, S, V) logits.  Caches are
per-stack dicts with the same leading unit axis; ``decode_step`` writes
each unit's new row into them in place and returns them.

Only the dense family is ported.  MoE, MLA, SSM, hybrid, encoder-decoder
and VLM models are ROADMAP.md's modules item 2, and ``build_model``
refuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from .attention import gqa
from .common import dense_init, rms_norm
from .moe import dense_ffn

__all__ = ["LayerSpec", "StackDef", "LMModel", "build_model", "chunked_ce_loss",
           "init_unit", "init_unit_cache", "apply_unit"]

# A sub-block: (kind, options). kinds ported: gqa | ffn
LayerSpec = tuple[tuple[str, dict], ...]

_FAMILY_ITEM = ("ROADMAP.md, modules queue item 2 (the other families' serving: "
                "vlm, moe, mla, ssm and hybrid, encdec)")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {_FAMILY_ITEM}")


# --------------------------------------------------------------------------
# Unit init / apply.
# --------------------------------------------------------------------------
def _init_sub(generator, kind: str, opt: dict, cfg: ArchConfig, dtype, lead: tuple):
    norm = torch.ones(lead + (cfg.d_model,), dtype=dtype)
    if kind == "gqa":
        return {"norm": norm, **gqa.init(generator, cfg, dtype, lead)}
    if kind == "ffn":
        d_ff = opt.get("d_ff", cfg.d_ff)
        return {"norm": norm, **dense_ffn.init(generator, cfg.d_model, d_ff, dtype, lead)}
    raise _unported(f"sub-block {kind!r}")


def init_unit(generator, spec: LayerSpec, cfg: ArchConfig, dtype, lead: tuple = ()) -> dict:
    """One unit's params; ``lead`` puts a leading axis (a stack's unit
    count) on every tensor, so a stack is drawn in one go."""
    return {
        f"sub{i}": _init_sub(generator, kind, opt, cfg, dtype, lead)
        for i, (kind, opt) in enumerate(spec)
    }


def init_unit_cache(
    spec: LayerSpec, cfg: ArchConfig, batch: int, cache_len: int, dtype,
    *, device=None, lead: tuple = (),
) -> dict:
    dev = resolve_device(device)
    out = {}
    for i, (kind, _) in enumerate(spec):
        if kind == "gqa":
            shape = lead + (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            out[f"sub{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                              "v": torch.zeros(shape, dtype=dtype, device=dev)}
        elif kind == "ffn":
            out[f"sub{i}"] = {}
        else:
            raise _unported(f"the {kind!r} cache")
    return out


def apply_unit(
    params: dict,
    x: torch.Tensor,
    spec: LayerSpec,
    cfg: ArchConfig,
    mode: str,                      # train | prefill | decode
    positions: Optional[torch.Tensor],
    cache: Optional[dict] = None,
    pos: int = 0,
    cache_len: int = 0,
):
    new_cache = {}
    for i, (kind, _) in enumerate(spec):
        p = params[f"sub{i}"]
        h = rms_norm(x, p["norm"], cfg.rms_eps)
        c = cache[f"sub{i}"] if cache is not None else None
        nc = {}
        if kind == "gqa":
            if mode == "train":
                y = gqa.forward_train(p, h, cfg, positions)
            elif mode == "prefill":
                y, nc = gqa.forward_prefill(p, h, cfg, positions, cache_len)
            else:
                y, nc = gqa.forward_decode(p, h, cfg, c, pos)
        elif kind == "ffn":
            y = dense_ffn.forward(p, h, cfg.act)
        else:
            raise _unported(f"sub-block {kind!r}")
        x = x + y
        new_cache[f"sub{i}"] = nc
    return x, new_cache


def _unit(tree: dict, u: int) -> dict:
    """Unit ``u``'s view of a stacked cache dict."""
    return {k: _unit(v, u) if isinstance(v, dict) else v[u] for k, v in tree.items()}


def _units(tree: dict, count: int) -> list:
    """Every unit's views of a stacked param dict, from one ``unbind`` per
    leaf: its backward stacks the ``count`` gradients into the leaf's once,
    where ``count`` selects would each add a zero-filled copy of the
    whole stack."""
    out = [{} for _ in range(count)]
    for k, v in tree.items():
        parts = _units(v, count) if isinstance(v, dict) else torch.unbind(v, 0)
        for u in range(count):
            out[u][k] = parts[u]
    return out


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


# --------------------------------------------------------------------------
# Loss (sequence-chunked CE: never holds (B, S, V) logits).
# --------------------------------------------------------------------------
class _ChunkedCE(torch.autograd.Function):
    """Mean next-token CE over sequence chunks.  The forward keeps only the
    running sum; the backward recomputes one chunk's logits at a time and
    turns them into their gradient in place, so at most one chunk's
    (B, chunk, V) f32 logits live in either pass."""

    @staticmethod
    def forward(ctx, h, labels, w_head, chunk: int):
        B, S, _ = h.shape
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, S, chunk):
            logits = (h[:, c0:c0 + chunk] @ w_head).to(torch.float32)  # (B, chunk, V)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[:, c0:c0 + chunk, None])[..., 0]
            tot = tot + torch.sum(lse - gold)
        ctx.save_for_backward(h, labels, w_head)
        ctx.chunk = chunk
        return tot / (B * S)

    @staticmethod
    def backward(ctx, g):
        h, labels, w_head = ctx.saved_tensors
        B, S, d = h.shape
        V = w_head.shape[1]
        scale = g.to(torch.float32) / (B * S)
        need_h, _, need_w, _ = ctx.needs_input_grad
        gh = torch.empty_like(h) if need_h else None
        gw = torch.zeros_like(w_head) if need_w else None
        for c0 in range(0, S, ctx.chunk):
            hc, lc = h[:, c0:c0 + ctx.chunk], labels[:, c0:c0 + ctx.chunk]
            n = hc.shape[0] * hc.shape[1]
            logits = (hc @ w_head).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            # d/dlogits = (softmax - onehot(label)) * g / (B S), in place
            p = logits.sub_(lse[..., None]).exp_().view(n, V)
            rows = torch.arange(n, device=p.device)
            gold = lc.reshape(n)
            p.index_put_((rows, gold), p[rows, gold] - 1.0)
            dl = p.mul_(scale).to(h.dtype)
            if need_h:
                gh[:, c0:c0 + ctx.chunk] = (dl @ w_head.T).view(hc.shape)
            if need_w:
                gw.addmm_(hc.reshape(n, d).T, dl)
            del logits, p, dl
        return gh, None, gw, None


def chunked_ce_loss(h: torch.Tensor, labels, w_head: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """h (B, S, d), labels (B, S) -> mean next-token CE (logits from w_head).

    ``chunk`` becomes the largest divisor of S at most the requested chunk,
    as in the reference.  Logits are ``(h @ w_head)`` cast to f32, one
    chunk at a time, in the forward and again in the backward."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:  # largest divisor of S at most the requested chunk
        chunk -= 1
    labels = torch.as_tensor(labels, device=h.device).long()
    return _ChunkedCE.apply(h, labels, w_head, chunk)


# --------------------------------------------------------------------------
# Model.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StackDef:
    count: int
    spec: LayerSpec


@dataclasses.dataclass(frozen=True)
class LMModel:
    cfg: ArchConfig
    stacks: tuple[StackDef, ...]

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator, dtype=torch.float32, *, device=None) -> dict:
        """Random params drawn from ``generator``, which must live on
        ``device`` (``None`` means the CUDA card)."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(f"the generator lives on {generator.device}, the params go to {dev}")
        with dev:
            return self._draw(generator, dtype)

    def param_shapes(self) -> dict:
        """The params' shapes, as nested dicts of tuples, drawn on no device."""
        with torch.device("meta"):
            params = self._draw(torch.Generator(), torch.float32)

        def shapes(tree):
            return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                    for k, v in tree.items()}
        return shapes(params)

    def _draw(self, generator, dtype) -> dict:
        cfg = self.cfg
        params: dict = {
            "embed": dense_init(generator, (cfg.vocab, cfg.d_model), dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dtype)
        for si, sd in enumerate(self.stacks):
            params[f"stack{si}"] = init_unit(generator, sd.spec, cfg, dtype, lead=(sd.count,))
        return params

    def _head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.scale_embed:
            d = torch.tensor(float(self.cfg.d_model), dtype=torch.float32, device=x.device)
            x = x * torch.sqrt(d).to(x.dtype)
        return x

    # --------------------------------------------------------------- runs
    def _run_stacks(self, params, x, mode, positions, caches=None, pos: int = 0,
                    cache_len: int = 0, remat: bool = False):
        """``remat`` (train mode, where autograd records): each unit runs
        under ``torch.utils.checkpoint``, which keeps only the unit's input
        and recomputes the unit in the backward pass.  The reference's
        ``jax.checkpoint`` policy (``dots_with_no_batch_dims_saveable``)
        also keeps some products; recomputing all of them changes memory
        and time, not values."""
        remat = remat and mode == "train" and torch.is_grad_enabled()
        new_caches = []
        for si, sd in enumerate(self.stacks):
            units = _units(params[f"stack{si}"], sd.count)
            unit_caches = []
            for u in range(sd.count):
                if remat:
                    x = checkpoint(
                        lambda h, p=units[u], spec=sd.spec: apply_unit(
                            p, h, spec, self.cfg, "train", positions)[0],
                        x, use_reentrant=False)
                    continue
                unit_c = _unit(caches[si], u) if mode == "decode" else None
                x, nc = apply_unit(
                    units[u], x, sd.spec, self.cfg, mode, positions,
                    cache=unit_c, pos=pos, cache_len=cache_len,
                )
                unit_caches.append(nc)
            if mode == "train":
                new_caches.append(None)
            elif mode == "prefill":
                new_caches.append(_stack(unit_caches))
            else:  # decode wrote into the stacked caches in place
                new_caches.append(caches[si])
        return x, new_caches

    def _tokens(self, params, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=params["embed"].device).long()

    def _inputs_to_x(self, params, batch):
        """Text tokens -> (x, positions)."""
        x = self._embed(params, self._tokens(params, batch["tokens"]))
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions

    # --------------------------------------------------------------- API
    def forward_train(self, params, batch, remat: bool = True) -> torch.Tensor:
        """-> final hidden states (B, S, d).  ``remat`` recomputes each unit
        in the backward pass (it has no effect where autograd records
        nothing, as in serving)."""
        x, positions = self._inputs_to_x(params, batch)
        x, _ = self._run_stacks(params, x, "train", positions, remat=remat)
        return rms_norm(x, params["final_norm"], self.cfg.rms_eps)

    def loss(self, params, batch, remat: bool = True) -> torch.Tensor:
        """Mean next-token CE of ``batch`` (``tokens``, ``labels``), a 0-d f32
        tensor; differentiate it with autograd."""
        h = self.forward_train(params, batch, remat=remat)
        return chunked_ce_loss(h, self._tokens(params, batch["labels"]), self._head(params))

    def prefill(self, params, batch, cache_len: int):
        """-> (last-token logits (B, V), caches)."""
        x, positions = self._inputs_to_x(params, batch)
        x, caches = self._run_stacks(params, x, "prefill", positions, cache_len=cache_len)
        h = rms_norm(x[:, -1, :], params["final_norm"], self.cfg.rms_eps)
        return h @ self._head(params), caches

    def init_caches(self, batch: int, cache_len: int, dtype=torch.float32, *, device=None):
        return [init_unit_cache(sd.spec, self.cfg, batch, cache_len, dtype,
                                device=device, lead=(sd.count,))
                for sd in self.stacks]

    def decode_step(self, params, tokens, caches, pos: int):
        """tokens (B, 1) -> (logits (B, V), caches): writes row ``pos`` of
        every unit's cache in place and returns the same caches."""
        x = self._embed(params, self._tokens(params, tokens))
        x, new_caches = self._run_stacks(params, x, "decode", None, caches=caches, pos=pos)
        h = rms_norm(x[:, -1, :], params["final_norm"], self.cfg.rms_eps)
        return h @ self._head(params), new_caches


# --------------------------------------------------------------------------
# Spec construction from ArchConfig.
# --------------------------------------------------------------------------
def build_model(cfg: ArchConfig) -> LMModel:
    """The dense LM; every other family raises, naming its ROADMAP item."""
    if cfg.family != "dense" or cfg.mla or cfg.moe or cfg.ssm or cfg.hybrid_period \
            or cfg.encdec or cfg.vlm:
        raise _unported(f"{cfg.name}: the {cfg.family!r} family")
    return LMModel(cfg=cfg, stacks=(StackDef(cfg.n_layers, (("gqa", {}), ("ffn", {}))),))
