"""The port's sub-blocks of the other model families against the
reference, on the CPU: the routed MoE (``moe_ffn``, ``pick_group_count``),
MLA with its absorbed-latent decode, the Mamba2 SSD block and the
cross-attention trio.  The whole models are in
``tests/test_torch_families_models.py``.

The same NumPy inputs, drawn from a seed, go through ``repro`` and
``repro_torch``; the weights are the reference's ``jax.random`` init carried
across as NumPy arrays.  Tolerances:
  * f32 outputs, caches and states: |port - reference| <= 1e-5 + 1e-5 |ref|
    (the same products summed in another order).  This covers the MoE's
    combine, a scatter-add in the reference and a gather and sum in
    ascending expert order in the port, and SSD's ``exp(cumsum)`` factors:
    the gaps seen are below 4e-6 on values of magnitude 1-4.
  * MoE routing: expert choices, the sort order, each pair's slot and
    which pairs drop are equal exactly, tied selection logits included.
  * Gradients of the MoE block: 1e-5 + 1e-4 |ref| (two more products in
    another order).
  * The port's own SSD against its own step recurrence: the reference
    test's rtol 2e-3 / atol 2e-4 (``tests/test_model_parts.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe

F32 = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b")


def close(got, want, **tol):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), **(tol or F32))


def rng_normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_arrays(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def cfgs(arch, **kw):
    """The reduced config in both packages, with the same replacements."""
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw))


# ---------------------------------------------------------------------- MoE
@pytest.mark.parametrize("n_tokens,n_experts,top_k", [
    (128, 256, 8), (4096 * 256, 256, 8), (8, 64, 6), (128, 64, 6), (16, 16, 2),
    (1, 8, 2), (1024, 8, 2), (3000, 16, 2), (96, 8, 2),
])
def test_pick_group_count_matches_the_reference(n_tokens, n_experts, top_k):
    got = tmoe.pick_group_count(n_tokens, n_experts, top_k)
    assert got == jmoe.pick_group_count(n_tokens, n_experts, top_k)
    assert got & (got - 1) == 0


def reference_routing(p, x, cfg):
    """The reference's routing and dispatch indices (``moe_ffn.forward``'s
    lines before the expert GEMMs), in jnp: -> top_idx, slot, keep, C."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = jmoe.pick_group_count(T, E, k)
    Sg = T // G
    xt = jnp.asarray(x).reshape(G, Sg, d)
    logits = jnp.einsum("gsd,de->gse", xt, p["router"]).astype(jnp.float32)
    select = logits + p["router_bias"] if cfg.router_aux_free else logits
    _, top_idx = jax.lax.top_k(select, k)
    C = int(Sg * k * cfg.capacity_factor / E) + 1
    C = max(8, ((C + 7) // 8) * 8)
    C = min(C, Sg * k)

    def group(idx_g):
        fe_ = idx_g.reshape(-1)
        order = jnp.argsort(fe_)
        se = fe_[order]
        pos = jnp.arange(se.shape[0]) - jnp.searchsorted(se, se, side="left")
        keep = pos < C
        return jnp.where(keep, se * C + pos, E * C), keep

    slot, keep = jax.vmap(group)(top_idx)
    return np.asarray(top_idx), np.asarray(slot), np.asarray(keep), C


def check_moe(jcfg, tcfg, p, x):
    """Routing, slots, drops and output equal the reference's; -> drops."""
    tp, tx = to_torch(p), torch.from_numpy(x)
    top_idx, slot, keep, C = reference_routing(p, x, jcfg)
    t_idx, _, t_C = tmoe.moe_ffn.route(tp, tx, tcfg)
    t_slot, _, t_keep = tmoe.moe_ffn.dispatch(t_idx, t_C, tcfg.n_experts)
    assert t_C == C
    np.testing.assert_array_equal(t_idx.numpy(), top_idx)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    close(tmoe.moe_ffn.forward(tp, tx, tcfg), jmoe.moe_ffn.forward(p, jnp.asarray(x), jcfg))
    return int((~keep).sum())


def moe_params(jcfg, seed, bias_seed=None):
    p = to_arrays(jmoe.moe_ffn.init(jax.random.key(seed), jcfg))
    if jcfg.router_aux_free and bias_seed is not None:  # the init zeroes it
        p["router_bias"] = rng_normal(bias_seed, p["router_bias"].shape, 0.05)
    return p


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_the_reference(arch):
    jcfg, tcfg = cfgs(arch)
    p = moe_params(jcfg, 1, bias_seed=30)
    assert tmoe.moe_ffn.init(torch.Generator().manual_seed(0), tcfg).keys() == p.keys()
    for B, S, seed in ((2, 8, 40), (8, 1, 41), (3, 32, 42)):  # several group counts
        check_moe(jcfg, tcfg, p, rng_normal(seed, (B, S, jcfg.d_model)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_drops_the_reference_slots(arch):
    """A capacity factor small enough that queues overflow: the same pairs
    go to the drop bin, and the outputs agree."""
    jcfg, tcfg = cfgs(arch, capacity_factor=0.5)
    p = moe_params(jcfg, 2, bias_seed=31)
    x = rng_normal(43, (4, 16, jcfg.d_model))
    assert check_moe(jcfg, tcfg, p, x) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_breaks_top_k_ties_as_the_reference(arch):
    """Tied selection logits: the router's columns in equal pairs (and a
    zero router, where every expert ties) choose the lower expert index
    first, as ``lax.top_k`` does, and the queues fill in the same order."""
    jcfg, tcfg = cfgs(arch)
    p = moe_params(jcfg, 3)
    E = jcfg.n_experts
    r = rng_normal(44, (jcfg.d_model, E // 2), 0.006)
    p["router"] = np.repeat(r, 2, axis=1)  # experts 2i and 2i+1 tie
    x = rng_normal(45, (4, 8, jcfg.d_model))
    check_moe(jcfg, tcfg, p, x)
    p["router"] = np.zeros_like(p["router"])  # every expert ties
    assert check_moe(jcfg, tcfg, p, x) > 0  # the lowest experts overflow
    z = np.zeros((1, 1, E), np.float32)  # -0.0 ranks below +0.0, as in lax.top_k
    z[..., 0] = -0.0
    got = tmoe._descending_order(torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy()[..., :E],
                                  np.asarray(jax.lax.top_k(jnp.asarray(z), E)[1]))


def test_moe_single_expert_equals_dense():
    """The reference test's premise (``tests/test_model_parts.py``) on the
    port: one expert, top-1, nothing dropped, equals the dense FFN."""
    _, tcfg = cfgs("deepseek-moe-16b", n_experts=1, top_k=1, n_shared=0, capacity_factor=2.0)
    p = tmoe.moe_ffn.init(torch.Generator().manual_seed(1), tcfg)
    x = torch.from_numpy(rng_normal(46, (2, 8, tcfg.d_model)))
    dense = {k: p[k][0] for k in ("w_gate", "w_up", "w_down")}
    torch.testing.assert_close(tmoe.moe_ffn.forward(p, x, tcfg),
                               tmoe.dense_ffn.forward(dense, x, tcfg.act), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_grads_match_the_reference(arch):
    jcfg, tcfg = cfgs(arch)
    p = moe_params(jcfg, 4, bias_seed=32)
    x = rng_normal(47, (2, 8, jcfg.d_model))
    jg = jax.grad(lambda pp: jnp.sum(jmoe.moe_ffn.forward(pp, jnp.asarray(x), jcfg) ** 2))(
        jax.tree.map(jnp.asarray, p))
    tp = to_torch(p)
    leaves = [t for k, t in tp.items() if not isinstance(t, dict)] + list(
        tp.get("shared", {}).values())
    for t in leaves:
        t.requires_grad_(True)
    (tmoe.moe_ffn.forward(tp, torch.from_numpy(x), tcfg) ** 2).sum().backward()
    for k, t in tp.items():
        for kk, tt in (t.items() if isinstance(t, dict) else [(None, t)]):
            want = jg[k][kk] if kk else jg[k]
            got = tt.grad if tt.grad is not None else torch.zeros_like(tt)
            close(got, want, rtol=1e-4, atol=1e-5)
    assert float(tp["router"].grad.abs().sum()) > 0 and float(tp["w_down"].grad.abs().sum()) > 0


def test_moe_f32_leaves_in_a_bf16_model():
    _, tcfg = cfgs("deepseek-v3-671b")
    p = tmoe.moe_ffn.init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert p["router_bias"].dtype == torch.float32 and p["router"].dtype == torch.bfloat16


# ---------------------------------------------------------------------- MLA
@pytest.mark.parametrize("q_lora_rank", [32, 0], ids=["q_lora", "w_q"])
def test_mla_train_prefill_and_two_decodes_match_the_reference(q_lora_rank):
    jcfg, tcfg = cfgs("deepseek-v3-671b", q_lora_rank=q_lora_rank)
    p = to_arrays(jattn.mla.init(jax.random.key(5), jcfg))
    tp = to_torch(p)
    assert tattn.mla.init(torch.Generator().manual_seed(0), tcfg).keys() == p.keys()
    B, S, L = 2, 6, 12
    x = rng_normal(50, (B, S, jcfg.d_model))
    pos = np.arange(S)
    close(tattn.mla.forward_train(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos)),
          jattn.mla.forward_train(p, jnp.asarray(x), jcfg, jnp.asarray(pos)))
    jy, jcache = jattn.mla.forward_prefill(p, jnp.asarray(x), jcfg, jnp.asarray(pos), L)
    ty, tcache = tattn.mla.forward_prefill(tp, torch.from_numpy(x), tcfg,
                                           torch.from_numpy(pos), L)
    close(ty, jy)
    assert tcache["c_kv"].shape == (B, L, jcfg.kv_lora_rank)
    assert tcache["k_rope"].shape == (B, L, jcfg.qk_rope_head_dim)
    for t in range(2):
        xd = rng_normal(51 + t, (B, 1, jcfg.d_model))
        jy, jcache = jattn.mla.forward_decode(p, jnp.asarray(xd), jcfg, jcache, S + t)
        ty, same = tattn.mla.forward_decode(tp, torch.from_numpy(xd), tcfg, tcache, S + t)
        assert same is tcache  # written in place
        close(ty, jy)
        for key in ("c_kv", "k_rope"):
            close(tcache[key], jcache[key])


def test_mla_absorbed_decode_equals_its_own_train_form():
    """Prefill of S - 1 rows and one absorbed decode give the materialized
    forward's last row (the teacher-forcing premise on one layer)."""
    _, tcfg = cfgs("deepseek-v3-671b")
    p = tattn.mla.init(torch.Generator().manual_seed(2), tcfg)
    S = 10
    x = torch.from_numpy(rng_normal(52, (2, S, tcfg.d_model)))
    full = tattn.mla.forward_train(p, x, tcfg, torch.arange(S))
    _, cache = tattn.mla.forward_prefill(p, x[:, :-1], tcfg, torch.arange(S - 1), S + 2)
    y, _ = tattn.mla.forward_decode(p, x[:, -1:], tcfg, cache, S - 1)
    torch.testing.assert_close(y[:, 0], full[:, -1], rtol=2e-2, atol=2e-3)


# ---------------------------------------------------------------- Mamba2 SSD
@pytest.mark.parametrize("arch,S", [("mamba2-370m", 16), ("mamba2-370m", 48),
                                    ("jamba-v0.1-52b", 12)])
def test_mamba2_train_state_and_decode_match_the_reference(arch, S):
    """S = 48 runs three chunks of 16; S = 12 one chunk of 12."""
    jcfg, tcfg = cfgs(arch)
    d = jcfg.d_model
    p = to_arrays(jmamba.mamba2.init(jax.random.key(6), jcfg, d))
    p["A_log"] = rng_normal(60, p["A_log"].shape, 0.5)  # the init zeroes it
    p["conv_b"] = rng_normal(61, p["conv_b"].shape, 0.1)
    tp = to_torch(p)
    B = 2
    x = rng_normal(62, (B, S, d), 0.5)
    jy, jst = jmamba.mamba2.forward_train(p, jnp.asarray(x), jcfg, d, return_state=True)
    ty, tst = tmamba.mamba2.forward_train(tp, torch.from_numpy(x), tcfg, d, return_state=True)
    close(ty, jy)
    close(tmamba.mamba2.forward_train(tp, torch.from_numpy(x), tcfg, d), jy)
    assert tst["ssm"].dtype == torch.float32
    for key in ("ssm", "conv"):
        assert tst[key].shape == jst[key].shape
        close(tst[key], jst[key])
    for t in range(2):
        xd = rng_normal(63 + t, (B, 1, d), 0.5)
        jy, jst = jmamba.mamba2.forward_decode(p, jnp.asarray(xd), jcfg, jst, d)
        ty, same = tmamba.mamba2.forward_decode(tp, torch.from_numpy(xd), tcfg, tst, d)
        assert same is tst  # written in place
        close(ty, jy)
        for key in ("ssm", "conv"):
            close(tst[key], jst[key])


def test_mamba2_init_and_cache_match_the_reference_layout():
    jcfg, tcfg = cfgs("jamba-v0.1-52b")
    d = jcfg.d_model
    want = to_arrays(jmamba.mamba2.init(jax.random.key(0), jcfg, d, jnp.bfloat16))
    got = tmamba.mamba2.init(torch.Generator().manual_seed(0), tcfg, d, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in ("A_log", "dt_bias", "D"):  # f32 leaves in a bf16 block
        assert got[k].dtype == torch.float32 and want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    jc = jmamba.mamba2.init_cache(jcfg, d, 3)
    tc = tmamba.mamba2.init_cache(tcfg, d, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}


def test_ssd_matches_naive_recurrence():
    """The reference's SSD-vs-recurrence test on the port: the chunked form
    equals its own decode run token by token."""
    _, tcfg = cfgs("mamba2-370m")
    d = 32
    p = tmamba.mamba2.init(torch.Generator().manual_seed(0), tcfg, d)
    B, S = 2, 32
    x = torch.from_numpy(rng_normal(64, (B, S, d), 0.5))
    y_par, st = tmamba.mamba2.forward_train(p, x, tcfg, d, return_state=True)
    cache = tmamba.mamba2.init_cache(tcfg, d, B, device="cpu")
    ys = [tmamba.mamba2.forward_decode(p, x[:, t:t + 1], tcfg, cache, d)[0] for t in range(S)]
    torch.testing.assert_close(torch.cat(ys, 1), y_par, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(cache["ssm"], st["ssm"], rtol=2e-3, atol=2e-4)
    # the conv window holds the same projected rows (one row's product at a
    # time against the whole sequence's: the last bit may differ)
    torch.testing.assert_close(cache["conv"], st["conv"], rtol=1e-5, atol=1e-6)


# -------------------------------------------------------- cross attention
def test_cross_attention_trio_matches_the_reference():
    jcfg, tcfg = cfgs("whisper-small")
    p = to_arrays(jattn.gqa.init(jax.random.key(7), jcfg))
    tp = to_torch(p)
    B, Sq, Se = 2, 5, 11
    x = rng_normal(70, (B, Sq, jcfg.d_model))
    src = rng_normal(71, (B, Se, jcfg.d_model))
    close(tattn.gqa.forward_cross(tp, torch.from_numpy(x), torch.from_numpy(src), tcfg),
          jattn.gqa.forward_cross(p, jnp.asarray(x), jnp.asarray(src), jcfg))
    jk, jv = jattn.gqa.cross_kv(p, jnp.asarray(src), jcfg)
    tk, tv = tattn.gqa.cross_kv(tp, torch.from_numpy(src), tcfg)
    close(tk, jk)
    close(tv, jv)
    xd = rng_normal(72, (B, 1, jcfg.d_model))
    got = tattn.gqa.forward_cross_cached(tp, torch.from_numpy(xd), tk, tv, tcfg)
    close(got, jattn.gqa.forward_cross_cached(p, jnp.asarray(xd), jk, jv, jcfg))
    # the cached form is the uncached one for a single query
    torch.testing.assert_close(
        got, tattn.gqa.forward_cross(tp, torch.from_numpy(xd), torch.from_numpy(src), tcfg),
        rtol=1e-5, atol=1e-6)
