"""The port's dense LM (``repro_torch.configs``, ``models``, ``launch.specs``,
``convert.lm_params_from_arrays``) against the reference, on the CPU.

The same NumPy inputs, drawn from a seed, go through ``repro`` and
``repro_torch``; the weights are the reference's ``jax.random`` init carried
across with ``lm_params_from_arrays`` (the reference's init cannot be
reproduced in torch).  Tolerances:
  * f32: |port - reference| <= 1e-5 + 1e-5 |reference| (the two sum the
    same products in another order; the largest gap seen is 1.3e-6 on
    hidden states of magnitude 3.5).
  * bf16 inputs and weights: hidden states within 0.05 absolute (three bf16
    ulps at magnitude 2-4, where one rounding flips in another order) and
    logits (magnitude below 1) within 1e-2.
  * Registry, shapes, batches and caches' layout: exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.specs import make_concrete_batch as jbatch
from repro.models import attention as jattn
from repro.models import common as jc
from repro.models import moe as jmoe
from repro.models.lm import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch.specs import make_concrete_batch as tbatch
from repro_torch.launch.specs import text_len
from repro_torch.models import attention as tattn
from repro_torch.models import common as tc
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import build_model as tbuild

F32 = dict(rtol=1e-5, atol=1e-5)
DENSE = ("llama3.2-3b", "gemma-2b", "qwen2-72b", "granite-3-8b")


def close(got, want, **tol):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), **(tol or F32))


def rng_normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def both(x: np.ndarray, dtype: str = "f32"):
    """The same values as a jax and a torch array of ``dtype``."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def to_arrays(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


# ------------------------------------------------------------------ registry
def test_registry_lists_the_same_configs():
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert set(tconfigs.SHAPES) == set(jconfigs.SHAPES)
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == dataclasses.asdict(shape)


@pytest.mark.parametrize("name", jconfigs.list_configs())
def test_every_config_and_its_reduction_equal_the_reference(name):
    got, want = tconfigs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    if want.n_heads:  # an attention-free model has no head width
        assert got.resolved_head_dim == want.resolved_head_dim
    for shape in jconfigs.SHAPES:
        assert tconfigs.shape_is_applicable(got, shape) == jconfigs.shape_is_applicable(
            want, shape)


# ------------------------------------------------------------ common blocks
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm(dtype):
    x = rng_normal(0, (2, 5, 64), 3.0)
    w = rng_normal(1, (64,)) + 1.0
    (jx, tx), (jw, tw) = both(x, dtype), both(w, dtype)
    got, want = tc.rms_norm(tx, tw, 1e-6), jc.rms_norm(jx, jw, 1e-6)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    # the f32 island: both round the same f32 result to bf16, so bf16 agrees too
    close(got, want, **(F32 if dtype == "f32" else dict(rtol=8e-3, atol=1e-2)))


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_act_fn(name):
    x = rng_normal(2, (4, 33), 4.0)
    jx, tx = both(x)
    close(tc.act_fn(name, tx), jc.act_fn(name, jx))
    with pytest.raises(ValueError):
        tc.act_fn("relu", tx)


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (128, 500_000.0)])
def test_rope_with_2d_and_3d_sin_cos(head_dim, theta):
    B, S, H = 2, 7, 3
    pos2 = np.arange(S, dtype=np.int32)
    pos3 = (np.arange(S)[None, :] + np.array([[0], [11]])).astype(np.int32)  # (B, S)
    x = rng_normal(3, (B, S, H, head_dim))
    jx, tx = both(x)
    for pos in (pos2, pos3):
        js, jco = jc.rope_sin_cos(jnp.asarray(pos), head_dim, theta)
        ts, tco = tc.rope_sin_cos(torch.from_numpy(pos), head_dim, theta)
        close(ts, js)
        close(tco, jco)
        close(tc.apply_rope(tx, ts, tco), jc.apply_rope(jx, js, jco))


ATTN_CASES = {
    # chunks smaller than S: several q and kv chunks
    "chunked": dict(Sq=12, Sk=12, q_chunk=4, kv_chunk=4),
    # a length no chunk divides: one block each
    "non_divisible": dict(Sq=10, Sk=10, q_chunk=4, kv_chunk=4),
    # queries placed at an offset into a ragged cache
    "offset_ragged": dict(Sq=4, Sk=12, q_chunk=2, kv_chunk=4, q_offset=6, kv_valid_len=9),
}


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention(heads, causal, case):
    H, Hkv = heads
    c = dict(ATTN_CASES[case])
    Sq, Sk = c.pop("Sq"), c.pop("Sk")
    B, Dh = 2, 8
    q, k, v = (rng_normal(s, (B, S, h, Dh)) for s, S, h in ((4, Sq, H), (5, Sk, Hkv),
                                                              (6, Sk, Hkv)))
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
    jkw = dict(causal=causal, q_chunk=c["q_chunk"], kv_chunk=c["kv_chunk"])
    tkw = dict(jkw)
    if "q_offset" in c:
        jkw.update(q_offset=jnp.int32(c["q_offset"]), kv_valid_len=jnp.int32(c["kv_valid_len"]))
        tkw.update(q_offset=c["q_offset"], kv_valid_len=c["kv_valid_len"])
    got = tc.chunked_attention(tq, tk, tv, **tkw)
    assert got.shape == (B, Sq, H, Dh)
    close(got, jc.chunked_attention(jq, jk, jv, **jkw))


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
def test_decode_attention_on_a_partly_filled_cache(heads):
    """Rows at ``pos`` and beyond hold large garbage: they take no weight."""
    H, Hkv = heads
    B, S, Dh, pos = 2, 16, 8, 7
    q = rng_normal(7, (B, 1, H, Dh))
    kc, vc = rng_normal(8, (B, S, Hkv, Dh)), rng_normal(9, (B, S, Hkv, Dh))
    kc[:, pos:] = 1e3
    vc[:, pos:] = -1e3
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(kc), both(vc)
    got = tc.decode_attention(tq, tk, tv, pos)
    close(got, jc.decode_attention(jq, jk, jv, jnp.int32(pos)))
    assert float(got.abs().max()) < 10.0


# ------------------------------------------------------------------- blocks
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-72b"])  # qwen2: qkv_bias
def test_gqa_prefill_then_decode(arch):
    cfg = jconfigs.get_config(arch).reduced()
    p = to_arrays(jattn.gqa.init(jax.random.key(1), cfg))
    if cfg.qkv_bias:  # the init zeroes the biases: give them values
        for i, b in enumerate(("bq", "bk", "bv")):
            p[b] = rng_normal(20 + i, p[b].shape, 0.1)
    tp = to_torch(p)
    B, S, L = 2, 6, 12
    x = rng_normal(10, (B, S, cfg.d_model))
    jx, tx = both(x)
    pos = np.arange(S)
    jy, jcache = jattn.gqa.forward_prefill(p, jx, cfg, jnp.asarray(pos), L)
    ty, tcache = tattn.gqa.forward_prefill(tp, tx, cfg, torch.from_numpy(pos), L)
    close(ty, jy)
    for key in ("k", "v"):
        assert tcache[key].shape == (B, L, cfg.n_kv_heads, cfg.resolved_head_dim)
        close(tcache[key], jcache[key])
    xd = rng_normal(11, (B, 1, cfg.d_model))
    jxd, txd = both(xd)
    jy, jcache = jattn.gqa.forward_decode(p, jxd, cfg, jcache, S)
    ty, tcache = tattn.gqa.forward_decode(tp, txd, cfg, tcache, S)
    close(ty, jy)
    for key in ("k", "v"):
        close(tcache[key], jcache[key])
    close(tattn.gqa.forward_train(tp, tx, cfg, torch.from_numpy(pos)),
          jattn.gqa.forward_train(p, jx, cfg, jnp.asarray(pos)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_dense_ffn(act):
    p = to_arrays(jmoe.dense_ffn.init(jax.random.key(2), 64, 128))
    x = rng_normal(12, (2, 5, 64))
    jx, tx = both(x)
    close(tmoe.dense_ffn.forward(to_torch(p), tx, act), jmoe.dense_ffn.forward(p, jx, act))


# -------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def models():
    """Per (arch, dtype): the reference's model and params, and the port's
    model with the same params carried across."""
    out = {}

    def get(arch, dtype="f32"):
        if (arch, dtype) not in out:
            cfg = jconfigs.get_config(arch).reduced()
            jm = jbuild(cfg)
            jp = jm.init(jax.random.key(0), jnp.bfloat16 if dtype == "bf16" else jnp.float32)
            tcfg = tconfigs.get_config(arch).reduced()
            tp = lm_params_from_arrays(tcfg, to_arrays(jp), device="cpu")
            out[arch, dtype] = (cfg, jm, jp, tbuild(tcfg), tp)
        return out[arch, dtype]
    return get


def test_make_concrete_batch_draws_the_reference_batch():
    for arch in ("llama3.2-3b", "internvl2-1b", "whisper-small"):
        cfg = tconfigs.get_config(arch).reduced()
        for step in ("train", "prefill", "decode"):
            want = jbatch(jconfigs.get_config(arch).reduced(), 12, 3, step, seed=4)
            got = tbatch(cfg, 12, 3, step, seed=4, device="cpu")
            assert set(got) == set(want)
            for key in want:
                assert got[key].device.type == "cpu"
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert text_len(cfg, 12) == (12 - cfg.n_patches if cfg.vlm else 12)


def test_param_layout_equals_the_reference(models):
    cfg, jm, jp, tm, tp = models("qwen2-72b")  # untied head, biases
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tm.param_shapes() == want
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert got == want
    tp2 = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tp2) == want
    # fresh caches: the reference's layout, and a decode from them at pos 0
    jcaches = jm.init_caches(2, 16)
    tcaches = tm.init_caches(2, 16, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tcaches) == jax.tree.map(
        lambda a: tuple(a.shape), jcaches)
    tok = np.array([[3], [250]], np.int32)
    jl, _ = jm.decode_step(jp, jnp.asarray(tok), jcaches, 0)
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok), tcaches, 0)
    close(tl, jl)
    bad = to_arrays(jp)
    bad["stack0"]["sub0"].pop("bq")
    with pytest.raises(ValueError, match="stack0.sub0"):
        lm_params_from_arrays(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_prefill_and_decode_match_the_reference(models, arch):
    cfg, jm, jp, tm, tp = models(arch)
    S, B = 12, 2
    jb = jbatch(cfg, S, B, "train")
    tb = tbatch(tm.cfg, S, B, "train", device="cpu")
    close(tm.forward_train(tp, tb), jm.forward_train(jp, jb, remat=False))

    L = S + 4
    jl, jcaches = jm.prefill(jp, {"tokens": jb["tokens"][:, :S - 2]}, L)
    tl, tcaches = tm.prefill(tp, {"tokens": tb["tokens"][:, :S - 2]}, L)
    close(tl, jl)
    assert jax.tree.map(lambda t: tuple(t.shape), tcaches) == jax.tree.map(
        lambda a: tuple(a.shape), jcaches)
    for key in ("k", "v"):
        close(tcaches[0]["sub0"][key], jcaches[0]["sub0"][key])
    for t in range(2):  # two steps, each fed the reference's greedy token
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jcaches = jm.decode_step(jp, jnp.asarray(tok), jcaches, S - 2 + t)
        tl, tcaches = tm.decode_step(tp, torch.from_numpy(tok), tcaches, S - 2 + t)
        close(tl, jl)
        for key in ("k", "v"):
            close(tcaches[0]["sub0"][key], jcaches[0]["sub0"][key])


@pytest.mark.parametrize("arch", DENSE)
def test_port_decode_matches_its_own_teacher_forcing(models, arch):
    """Prefill + decode agrees with the parallel forward, at the reference
    test's tolerance (``tests/test_models_smoke.py``)."""
    _, _, _, tm, tp = models(arch)
    S = 16
    batch = tbatch(tm.cfg, S, 1, "train", seed=2, device="cpu")
    h = tm.forward_train(tp, batch)
    logits_par = (h[:, -1, :] @ tm._head(tp)).numpy()
    _, caches = tm.prefill(tp, {"tokens": batch["tokens"][:, :S - 1]}, S + 4)
    logits_dec, _ = tm.decode_step(tp, batch["tokens"][:, S - 1:], caches, S - 1)
    np.testing.assert_allclose(logits_par, logits_dec.numpy(), rtol=2e-2, atol=2e-3)


def test_lm_bf16_matches_the_reference(models):
    cfg, jm, jp, tm, tp = models("llama3.2-3b", "bf16")
    assert tp["embed"].dtype == torch.bfloat16
    jb = jbatch(cfg, 12, 2, "train")
    tb = tbatch(tm.cfg, 12, 2, "train", device="cpu")
    h = tm.forward_train(tp, tb)
    assert h.dtype == torch.bfloat16
    close(h, jm.forward_train(jp, jb, remat=False), rtol=0, atol=0.05)
    jl, jcaches = jm.prefill(jp, {"tokens": jb["tokens"]}, 16)
    tl, tcaches = tm.prefill(tp, {"tokens": tb["tokens"]}, 16)
    close(tl, jl, rtol=0, atol=1e-2)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    jl, _ = jm.decode_step(jp, jnp.asarray(tok), jcaches, 12)
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok), tcaches, 12)
    close(tl, jl, rtol=0, atol=1e-2)
