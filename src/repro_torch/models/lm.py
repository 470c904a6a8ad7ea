"""Language-model assembly (counterpart of ``repro.models.lm``): layer specs
-> stacks of identical units -> the model.

A model is a sequence of *stacks*; each stack holds ``count`` identical
*units*; a unit is an ordered list of sub-blocks (pre-norm residual each):

    dense LM            : 1 stack,  unit = [gqa, ffn]            x n_layers
    deepseek-moe        : 2 stacks, [gqa, ffn] x 1 ; [gqa, moe]  x 27
    deepseek-v3         : 2 stacks, [mla, ffn] x 3 ; [mla, moe]  x 58
    jamba               : 1 stack,  unit = 8 sub-layer pairs (1 gqa : 7
                          mamba, MoE every 2nd)                  x 4
    mamba2              : 1 stack,  unit = [mamba]                x 48
    whisper (enc-dec)   : an encoder stack [gqa, ffn] (not causal) and a
                          decoder stack [gqa, cross, ffn]
    internvl2 (vlm)     : the dense LM over [patch embeds ; token embeds]

Params are the reference's pytree as tensors: ``embed`` (V, d),
``final_norm``, ``lm_head`` (d, V) when the embeddings are untied,
``enc_final_norm`` for an encoder-decoder, and ``stack{i}.sub{j}.{norm,
wq, ...}`` with a leading unit axis.  Where the reference scans a stack,
the port loops over its units in Python; each unit's params are views of
the stacked tensors (``torch.unbind``, whose backward stacks the units'
gradients into the stacked leaf once).  Training recomputes each unit in
the backward pass (``remat``, ``torch.utils.checkpoint``), and the loss is
sequence-chunked (``chunked_ce_loss``): it never holds (B, S, V) logits.
Caches are per-stack dicts with the same leading unit axis (``None`` for
an encoder stack); ``decode_step`` has every sub-block write its new state
into them in place (a GQA or MLA row, a Mamba state and conv window; a
cross-attention cache is left as it is) and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..dist import hints
from .attention import gqa, mla
from .common import dense_init, rms_norm
from .mamba import mamba2
from .moe import dense_ffn, moe_ffn

__all__ = ["LayerSpec", "StackDef", "LMModel", "build_model", "chunked_ce_loss",
           "init_unit", "init_unit_cache", "apply_unit"]

# A sub-block: (kind, options). kinds: gqa | mla | mamba | ffn | moe | cross
LayerSpec = tuple[tuple[str, dict], ...]


# --------------------------------------------------------------------------
# Unit init / apply.
# --------------------------------------------------------------------------
def _init_sub(generator, kind: str, opt: dict, cfg: ArchConfig, dtype, lead: tuple):
    norm = torch.ones(lead + (cfg.d_model,), dtype=dtype)
    if kind in ("gqa", "cross"):
        return {"norm": norm, **gqa.init(generator, cfg, dtype, lead)}
    if kind == "mla":
        return {"norm": norm, **mla.init(generator, cfg, dtype, lead)}
    if kind == "mamba":
        return {"norm": norm, **mamba2.init(generator, cfg, cfg.d_model, dtype, lead)}
    if kind == "ffn":
        d_ff = opt.get("d_ff", cfg.d_ff)
        return {"norm": norm, **dense_ffn.init(generator, cfg.d_model, d_ff, dtype, lead)}
    if kind == "moe":
        return {"norm": norm, **moe_ffn.init(generator, cfg, dtype, lead)}
    raise ValueError(kind)


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

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    out = {}
    for i, (kind, _) in enumerate(spec):
        hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        if kind == "gqa":
            out[f"sub{i}"] = {"k": zeros(batch, cache_len, hkv, hd),
                              "v": zeros(batch, cache_len, hkv, hd)}
        elif kind == "mla":
            out[f"sub{i}"] = {"c_kv": zeros(batch, cache_len, cfg.kv_lora_rank),
                              "k_rope": zeros(batch, cache_len, cfg.qk_rope_head_dim)}
        elif kind == "mamba":
            out[f"sub{i}"] = mamba2.init_cache(cfg, cfg.d_model, batch, dtype, device=dev,
                                               lead=lead)
        elif kind == "cross":
            out[f"sub{i}"] = {"ck": zeros(batch, cfg.enc_seq, hkv, hd),
                              "cv": zeros(batch, cfg.enc_seq, hkv, hd)}
        else:
            out[f"sub{i}"] = {}
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
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
):
    """One unit.  In decode mode every sub-block writes its new state into
    ``cache`` in place; the returned caches are the same tensors."""
    new_cache = {}
    for i, (kind, _) in enumerate(spec):
        p = params[f"sub{i}"]
        h = rms_norm(x, p["norm"], cfg.rms_eps)
        c = cache[f"sub{i}"] if cache is not None else None
        nc = {}
        if kind == "gqa":
            if mode == "train":
                y = gqa.forward_train(p, h, cfg, positions, causal=causal)
            elif mode == "prefill":
                y, nc = gqa.forward_prefill(p, h, cfg, positions, cache_len)
            else:
                y, nc = gqa.forward_decode(p, h, cfg, c, pos)
        elif kind == "mla":
            if mode == "train":
                y = mla.forward_train(p, h, cfg, positions)
            elif mode == "prefill":
                y, nc = mla.forward_prefill(p, h, cfg, positions, cache_len)
            else:
                y, nc = mla.forward_decode(p, h, cfg, c, pos)
        elif kind == "mamba":
            if mode == "train":
                y = mamba2.forward_train(p, h, cfg, cfg.d_model)
            elif mode == "prefill":
                y, nc = mamba2.forward_train(p, h, cfg, cfg.d_model, return_state=True)
            else:
                y, nc = mamba2.forward_decode(p, h, cfg, c, cfg.d_model)
        elif kind == "cross":
            if mode == "train":
                y = gqa.forward_cross(p, h, enc_out, cfg)
            elif mode == "prefill":
                ck, cv = gqa.cross_kv(p, enc_out, cfg)
                y = gqa.forward_cross(p, h, enc_out, cfg)
                nc = {"ck": ck, "cv": cv}
            else:
                y = gqa.forward_cross_cached(p, h, c["ck"], c["cv"], cfg)
                nc = c
        elif kind == "ffn":
            y = dense_ffn.forward(p, h, cfg.act)
        elif kind == "moe":
            y = moe_ffn.forward(p, h, cfg)
        else:
            raise ValueError(kind)
        x = hints.act(x + y)  # re-anchor the residual stream's sharding
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
def _ce_sum(h, labels, w_head, chunk: int) -> torch.Tensor:
    """Sum over (B, S) of logsumexp - gold logit, one chunk's f32 logits at
    a time."""
    B, S, _ = h.shape
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        logits = (h[:, c0:c0 + chunk] @ w_head).to(torch.float32)  # (B, chunk, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c0:c0 + chunk, None])[..., 0]
        tot = tot + torch.sum(lse - gold)
    return tot


def _ce_grads(h, labels, w_head, chunk: int, scale, need_h: bool, need_w: bool):
    """(d/dh, d/dw_head) of ``scale`` x ``_ce_sum``, recomputing one chunk's
    logits at a time and turning them into their gradient in place."""
    B, S, d = h.shape
    V = w_head.shape[1]
    gh = torch.empty_like(h) if need_h else None
    gw = torch.zeros_like(w_head) if need_w else None
    for c0 in range(0, S, chunk):
        hc, lc = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        n = hc.shape[0] * hc.shape[1]
        logits = (hc @ w_head).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        # d/dlogits = (softmax - onehot(label)) * scale, in place
        p = logits.sub_(lse[..., None]).exp_().view(n, V)
        rows = torch.arange(n, device=p.device)
        gold = lc.reshape(n)
        p.index_put_((rows, gold), p[rows, gold] - 1.0)
        dl = p.mul_(scale).to(h.dtype)
        if need_h:
            gh[:, c0:c0 + chunk] = (dl @ w_head.T).view(hc.shape)
        if need_w:
            gw.addmm_(hc.reshape(n, d).T, dl)
        del logits, p, dl
    return gh, gw


class _ChunkedCE(torch.autograd.Function):
    """Mean next-token CE over sequence chunks.  The forward keeps only the
    running sum; the backward recomputes one chunk's logits at a time and
    turns them into their gradient in place, so at most one chunk's
    (B, chunk, V) f32 logits live in either pass."""

    @staticmethod
    def forward(ctx, h, labels, w_head, chunk: int):
        B, S, _ = h.shape
        ctx.save_for_backward(h, labels, w_head)
        ctx.chunk = chunk
        return _ce_sum(h, labels, w_head, chunk) / (B * S)

    @staticmethod
    def backward(ctx, g):
        h, labels, w_head = ctx.saved_tensors
        B, S, _ = h.shape
        need_h, _, need_w, _ = ctx.needs_input_grad
        gh, gw = _ce_grads(h, labels, w_head, ctx.chunk, g.to(torch.float32) / (B * S),
                           need_h, need_w)
        return gh, None, gw, None


class _ShardedChunkedCE(torch.autograd.Function):
    """``_ChunkedCE`` on DTensors split over the batch alone (the head
    replicated): each rank sums its rows' CE on its local tensors, one
    all-reduce over the batch's mesh dims makes the mean, and the head's
    gradient goes back as a partial sum over those dims."""

    @staticmethod
    def forward(ctx, h, labels, w_head, chunk: int):
        from torch.distributed.tensor import DTensor

        B, S, _ = h.shape  # the global shape
        hl, ll, wl = h.to_local(), labels.to_local(), w_head.to_local()
        ctx.save_for_backward(hl, ll, wl)
        mesh = h.device_mesh
        ctx.chunk, ctx.layout, ctx.n = chunk, (mesh, h.placements), B * S
        tot = DTensor.from_local(_ce_sum(hl, ll, wl, chunk) / (B * S), mesh,
                                 _batch_partial(h.placements))
        return tot.redistribute(mesh, _replicated(mesh))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        hl, ll, wl = ctx.saved_tensors
        mesh, h_place = ctx.layout
        need_h, _, need_w, _ = ctx.needs_input_grad
        g = g.redistribute(mesh, _replicated(mesh)).to_local()
        gh, gw = _ce_grads(hl, ll, wl, ctx.chunk, g.to(torch.float32) / ctx.n,
                           need_h, need_w)
        if need_h:
            gh = DTensor.from_local(gh, mesh, h_place)
        if need_w:
            gw = DTensor.from_local(gw, mesh, _batch_partial(h_place))
        return gh, None, gw, None


def _replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))


def _batch_rows(placements) -> tuple:
    """Placements that keep dim 0's split and replicate the rest."""
    from torch.distributed.tensor import Replicate

    return tuple(p if p.is_shard(0) else Replicate() for p in placements)


def _batch_partial(placements) -> tuple:
    """A partial sum over the mesh dims that split dim 0."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if p.is_shard(0) else Replicate() for p in placements)


def chunked_ce_loss(h: torch.Tensor, labels, w_head: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """h (B, S, d), labels (B, S) -> mean next-token CE (logits from w_head).

    ``chunk`` becomes the largest divisor of S at most the requested chunk,
    as in the reference.  Logits are ``(h @ w_head)`` cast to f32, one
    chunk at a time, in the forward and again in the backward.  On a
    DTensor ``h`` the rows keep their batch split, the head is gathered
    whole, and each rank runs the chunks of its own rows."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:  # largest divisor of S at most the requested chunk
        chunk -= 1
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(h, DTensor):
        labels = torch.as_tensor(labels, device=h.device).long()
        return _ChunkedCE.apply(h, labels, w_head, chunk)
    mesh = h.device_mesh
    rows = _batch_rows(h.placements)
    if isinstance(labels, DTensor):
        labels = labels.redistribute(mesh, rows)
    else:
        labels = distribute_tensor(torch.as_tensor(labels, device=h.to_local().device),
                                   mesh, rows)
    return _ShardedChunkedCE.apply(h.redistribute(mesh, rows), labels.long(),
                                   w_head.redistribute(mesh, _replicated(mesh)), chunk)


# --------------------------------------------------------------------------
# Model.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StackDef:
    count: int
    spec: LayerSpec
    role: str = "decoder"  # decoder | encoder


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
        if cfg.encdec:
            params["enc_final_norm"] = torch.ones((cfg.d_model,), dtype=dtype)
        for si, sd in enumerate(self.stacks):
            params[f"stack{si}"] = init_unit(generator, sd.spec, cfg, dtype, lead=(sd.count,))
        return params

    def _head(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _embed(self, params, tokens):
        x = hints.rows(params["embed"], tokens)
        if self.cfg.scale_embed:
            d = torch.tensor(float(self.cfg.d_model), dtype=torch.float32, device=x.device)
            x = x * torch.sqrt(d).to(x.dtype)
        return x

    # --------------------------------------------------------------- runs
    def _run_stacks(self, params, x, mode, positions, caches=None, pos: int = 0,
                    cache_len: int = 0, enc_out=None, role: str = "decoder",
                    remat: bool = False, causal: bool = True):
        """Runs the stacks of ``role``; the others keep their caches (or
        ``None``).  ``remat`` (train mode, where autograd records): each
        unit runs under ``torch.utils.checkpoint``, which keeps only the
        unit's input and recomputes the unit in the backward pass.  The
        reference's ``jax.checkpoint`` policy
        (``dots_with_no_batch_dims_saveable``) also keeps some products;
        recomputing all of them changes memory and time, not values."""
        remat = remat and mode == "train" and torch.is_grad_enabled()
        new_caches = []
        for si, sd in enumerate(self.stacks):
            if sd.role != role:
                new_caches.append(caches[si] if caches else None)
                continue
            units = _units(params[f"stack{si}"], sd.count)
            unit_caches = []
            for u in range(sd.count):
                if remat:
                    x = checkpoint(
                        lambda h, p=units[u], spec=sd.spec: apply_unit(
                            p, h, spec, self.cfg, "train", positions,
                            enc_out=enc_out, causal=causal)[0],
                        x, use_reentrant=False)
                    continue
                unit_c = _unit(caches[si], u) if mode == "decode" else None
                x, nc = apply_unit(
                    units[u], x, sd.spec, self.cfg, mode, positions,
                    cache=unit_c, pos=pos, cache_len=cache_len, enc_out=enc_out,
                    causal=causal,
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

    def _modality(self, params, a) -> torch.Tensor:
        return torch.as_tensor(a, device=params["embed"].device)

    def _encode(self, params, enc_frames, remat: bool = False):
        """The whisper encoder over stubbed conv-frontend frames (B, Se, d):
        a sinusoidal position embedding, the encoder stacks (not causal),
        ``enc_final_norm``."""
        cfg = self.cfg
        Se = enc_frames.shape[1]
        pos = torch.arange(Se, device=enc_frames.device)
        half = cfg.d_model // 2
        freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=pos.device)
                          * (9.21 / max(half - 1, 1)))
        ang = pos[:, None].to(torch.float32) * freqs[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        x = enc_frames + pe[None].to(enc_frames.dtype)
        x, _ = self._run_stacks(params, x, "train", pos, role="encoder", remat=remat,
                                causal=False)
        return rms_norm(x, params["enc_final_norm"], cfg.rms_eps)

    def _inputs_to_x(self, params, batch, remat: bool = False):
        """Merge the modality inputs -> (x, positions, enc_out): a VLM's
        patch embeddings go before the token embeddings; an
        encoder-decoder's frames go through the encoder."""
        cfg = self.cfg
        x = self._embed(params, self._tokens(params, batch["tokens"]))
        enc_out = None
        if cfg.vlm:
            vis = self._modality(params, batch["vision_embeds"])
            x = torch.cat([vis.to(x.dtype), x], dim=1)
        if cfg.encdec:
            enc_out = self._encode(params, self._modality(params, batch["enc_frames"]),
                                   remat=remat)
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions, enc_out

    # --------------------------------------------------------------- API
    def forward_train(self, params, batch, remat: bool = True) -> torch.Tensor:
        """-> final hidden states (B, S, d).  ``remat`` recomputes each unit
        in the backward pass (it has no effect where autograd records
        nothing, as in serving)."""
        x, positions, enc_out = self._inputs_to_x(params, batch, remat=remat)
        x, _ = self._run_stacks(params, x, "train", positions, enc_out=enc_out, remat=remat)
        return rms_norm(x, params["final_norm"], self.cfg.rms_eps)

    def loss(self, params, batch, remat: bool = True) -> torch.Tensor:
        """Mean next-token CE of ``batch`` (``tokens``, ``labels`` and the
        modality inputs), a 0-d f32 tensor; differentiate it with autograd.
        A VLM's loss covers the text positions only."""
        h = self.forward_train(params, batch, remat=remat)
        if self.cfg.vlm:
            h = h[:, self.cfg.n_patches:, :]
        return chunked_ce_loss(h, self._tokens(params, batch["labels"]), self._head(params))

    def prefill(self, params, batch, cache_len: int):
        """-> (last-token logits (B, V), caches)."""
        x, positions, enc_out = self._inputs_to_x(params, batch)
        x, caches = self._run_stacks(params, x, "prefill", positions, cache_len=cache_len,
                                     enc_out=enc_out)
        h = rms_norm(x[:, -1, :], params["final_norm"], self.cfg.rms_eps)
        return h @ self._head(params), caches

    def init_caches(self, batch: int, cache_len: int, dtype=torch.float32, *, device=None):
        """Zeroed caches per stack (``None`` for an encoder stack)."""
        return [init_unit_cache(sd.spec, self.cfg, batch, cache_len, dtype,
                                device=device, lead=(sd.count,))
                if sd.role == "decoder" else None
                for sd in self.stacks]

    def decode_step(self, params, tokens, caches, pos: int):
        """tokens (B, 1) -> (logits (B, V), caches): every unit writes its
        new state (row ``pos`` of an attention cache, a Mamba state) into
        the caches in place, and the same caches are returned."""
        x = self._embed(params, self._tokens(params, tokens))
        x, new_caches = self._run_stacks(params, x, "decode", None, caches=caches, pos=pos)
        h = rms_norm(x[:, -1, :], params["final_norm"], self.cfg.rms_eps)
        return h @ self._head(params), new_caches


# --------------------------------------------------------------------------
# Spec construction from ArchConfig.
# --------------------------------------------------------------------------
def build_model(cfg: ArchConfig) -> LMModel:
    attn_kind = "mla" if cfg.mla else "gqa"
    stacks: list[StackDef] = []

    if cfg.encdec:
        enc_spec: LayerSpec = (("gqa", {}), ("ffn", {}))
        dec_spec: LayerSpec = (("gqa", {}), ("cross", {}), ("ffn", {}))
        stacks.append(StackDef(cfg.n_enc_layers, enc_spec, role="encoder"))
        stacks.append(StackDef(cfg.n_layers, dec_spec, role="decoder"))
    elif cfg.hybrid_period:
        sub: list[tuple[str, dict]] = []
        for i in range(cfg.hybrid_period):
            mixer = "gqa" if i in cfg.attn_positions else "mamba"
            ff = "moe" if (cfg.moe and i % cfg.moe_period == 1) else "ffn"
            sub.append((mixer, {}))
            sub.append((ff, {}))
        stacks.append(StackDef(cfg.n_layers // cfg.hybrid_period, tuple(sub)))
    elif cfg.ssm:
        stacks.append(StackDef(cfg.n_layers, (("mamba", {}),)))
    elif cfg.moe:
        if cfg.n_dense_layers:
            dspec: LayerSpec = (
                (attn_kind, {}),
                ("ffn", {"d_ff": cfg.d_ff_dense or cfg.d_ff}),
            )
            stacks.append(StackDef(cfg.n_dense_layers, dspec))
        mspec: LayerSpec = ((attn_kind, {}), ("moe", {}))
        stacks.append(StackDef(cfg.n_layers - cfg.n_dense_layers, mspec))
    else:
        stacks.append(StackDef(cfg.n_layers, ((attn_kind, {}), ("ffn", {}))))
    return LMModel(cfg=cfg, stacks=tuple(stacks))
