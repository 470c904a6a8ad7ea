"""The port's other model families whole (``build_model`` for the VLM, MoE,
MLA, SSM, hybrid and encoder-decoder configs, ``GenerationEngine``, the
serving CLI) against the reference, on the CPU, each config ``.reduced()``.

The same NumPy batches (``make_concrete_batch``, drawn from a seed in the
reference's order) go through ``repro`` and ``repro_torch``; the weights
are the reference's ``jax.random`` init carried across with
``convert.lm_params_from_arrays``.  Tolerances:
  * f32 hidden states, logits and caches: |port - reference| <= 1e-5 +
    1e-5 |ref| (the same products summed in another order; the largest gap
    seen is 3.3e-6 on jamba's hidden states of magnitude 3.8).
  * The loss: rtol 1e-5.  Its grads: |port - reference| <= 1e-5 + 1e-4
    |ref| leaf by leaf (a backward pass sums each leaf's products in
    another order again).
  * Decode against the port's own parallel forward: the reference's
    teacher-forcing test's rtol 2e-2 / atol 2e-3
    (``tests/test_models_smoke.py``).
  * Layouts, greedy tokens and dtypes: exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.specs import make_concrete_batch as jbatch
from repro.models.lm import build_model as jbuild
from repro.serve.engine import GenerationEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as tserve
from repro_torch.launch.specs import make_concrete_batch as tbatch
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import GenerationEngine
from repro_torch.train._tree import leaves

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
FAMILIES = ("internvl2-1b", "deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b",
            "mamba2-370m", "whisper-small")


def close(got, want, **tol):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), **(tol or F32))


def shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def flat(tree, path=""):
    """{path: array} of a nested dict/list pytree, ``None`` leaves kept."""
    if tree is None:
        return {path: None}
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}.{k}".lstrip(".")))
        return out
    return {path: tree}


def close_trees(got, want, **tol):
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for k in w:
        if w[k] is None:
            assert g[k] is None, k
        else:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            close(g[k], w[k], **tol)


@pytest.fixture(scope="module")
def models():
    """Per arch: the reference's model and params, and the port's model
    with the same params carried across."""
    out = {}

    def get(arch):
        if arch not in out:
            cfg = jconfigs.get_config(arch).reduced()
            jm = jbuild(cfg)
            jp = jm.init(jax.random.key(0))
            tcfg = tconfigs.get_config(arch).reduced()
            tp = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
            out[arch] = (cfg, jm, jp, tbuild(tcfg), tp)
        return out[arch]
    return get


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_and_cache_layout_equal_the_reference(models, arch):
    cfg, jm, jp, tm, tp = models(arch)
    want = shapes(jp)
    assert tm.param_shapes() == want
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == want
    tp2 = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tp2) == want
    assert [sd.role for sd in tm.stacks] == [sd.role for sd in jm.stacks]
    assert [sd.spec for sd in tm.stacks] == [sd.spec for sd in jm.stacks]
    jc = jm.init_caches(2, 24)
    tc = tm.init_caches(2, 24, device="cpu")
    g, w = flat(tc), flat(jc)
    assert set(g) == set(w)
    for k in w:
        assert (g[k] is None) == (w[k] is None), k
        if w[k] is not None:
            assert tuple(g[k].shape) == w[k].shape, k
            assert (g[k].dtype == torch.float32) == (w[k].dtype == jnp.float32), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_params_keep_their_f32_leaves(arch):
    """A bf16 model's f32 leaves (``router_bias``, ``A_log``, ``dt_bias``,
    ``D``) stay f32 in the port's init and across ``lm_params_from_arrays``;
    every other leaf is bf16, ``enc_final_norm`` included."""
    cfg = jconfigs.get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.key(0), jnp.bfloat16))
    tcfg = tconfigs.get_config(arch).reduced()
    tp = lm_params_from_arrays(tcfg, jp, device="cpu")
    own = tbuild(tcfg).init(torch.Generator().manual_seed(0), torch.bfloat16, device="cpu")
    want = {k: v.dtype == np.float32 for k, v in flat(jp).items()}
    assert {k: v.dtype == torch.float32 for k, v in flat(tp).items()} == want
    assert {k: v.dtype == torch.float32 for k, v in flat(own).items()} == want
    f32_leaves = {k.rsplit(".", 1)[-1] for k, v in want.items() if v}
    assert f32_leaves <= {"router_bias", "A_log", "dt_bias", "D"}
    assert bool(f32_leaves) == bool(cfg.router_aux_free or cfg.ssm)
    assert ("enc_final_norm" in tp) == cfg.encdec
    for k, v in flat(tp).items():
        np.testing.assert_array_equal(v.to(torch.float32).numpy(),
                                      np.asarray(flat(jp)[k], np.float32))


def test_lm_params_from_arrays_checks_the_families_leaves(models):
    cfg, _, jp, _, _ = models("whisper-small")
    bad = jax.tree.map(np.asarray, jp)
    bad.pop("enc_final_norm")
    with pytest.raises(ValueError, match="params: keys"):
        lm_params_from_arrays(cfg, bad, device="cpu")
    cfg, _, jp, _, _ = models("jamba-v0.1-52b")
    bad = jax.tree.map(np.asarray, jp)
    bad["stack0"]["sub0"]["A_log"] = bad["stack0"]["sub0"]["A_log"][:, :-1]
    with pytest.raises(ValueError, match="stack0.sub0.A_log"):
        lm_params_from_arrays(cfg, bad, device="cpu")


def _prompt(batch: dict, n_text: int) -> dict:
    """The batch's first ``n_text`` tokens with its modality inputs."""
    out = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    out["tokens"] = batch["tokens"][:, :n_text]
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_and_two_decodes_match_the_reference(models, arch):
    cfg, jm, jp, tm, tp = models(arch)
    S, B = 16, 2
    jb = jbatch(cfg, S, B, "train")
    tb = tbatch(tm.cfg, S, B, "train", device="cpu")
    close(tm.forward_train(tp, tb), jm.forward_train(jp, jb, remat=False))

    n_text = jb["tokens"].shape[1] - 2
    L = S + 8
    jl, jcaches = jm.prefill(jp, _prompt(jb, n_text), L)
    tl, tcaches = tm.prefill(tp, _prompt(tb, n_text), L)
    close(tl, jl)
    close_trees(tcaches, jcaches)
    pos = n_text + (cfg.n_patches if cfg.vlm else 0)
    for t in range(2):  # two steps, each fed the reference's greedy token
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jcaches = jm.decode_step(jp, jnp.asarray(tok), jcaches, pos + t)
        tl, same = tm.decode_step(tp, torch.from_numpy(tok), tcaches, pos + t)
        assert all(a is b for a, b in zip(same, tcaches))  # written in place
        close(tl, jl)
        close_trees(tcaches, jcaches)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_the_reference(models, arch):
    """``test_train_step_smoke``'s premise (``tests/test_models_smoke.py``)
    held to the reference: the loss (a VLM's over its text positions only)
    and every leaf's gradient."""
    cfg, jm, jp, tm, tp = models(arch)
    jb = jbatch(cfg, 32, 2, "train")
    tb = tbatch(tm.cfg, 32, 2, "train", device="cpu")
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    flat_p = leaves(tp)
    for t in flat_p:
        t.requires_grad_(True)
    try:
        loss = tm.loss(tp, tb)
        # router_bias only selects experts: its grad is zero (None here)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            flat_p, torch.autograd.grad(loss, flat_p, allow_unused=True))]
    finally:
        for t in flat_p:
            t.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        close(g, w, **GRAD)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ["internvl2-1b", "mamba2-370m", "whisper-small"])
def test_port_decode_matches_its_own_teacher_forcing(models, arch):
    """Prefill of S - 1 text tokens (after the patches, or beside the
    encoder's frames) + one decode equals the parallel forward's last
    logits, at the reference test's tolerance."""
    _, _, _, tm, tp = models(arch)
    S = 16
    batch = tbatch(tm.cfg, S, 1, "train", seed=2, device="cpu")
    n_text = batch["tokens"].shape[1]
    h = tm.forward_train(tp, batch)
    logits_par = (h[:, -1, :] @ tm._head(tp)).numpy()
    pos = n_text - 1 + (tm.cfg.n_patches if tm.cfg.vlm else 0)
    _, caches = tm.prefill(tp, _prompt(batch, n_text - 1), pos + 4)
    logits_dec, _ = tm.decode_step(tp, batch["tokens"][:, n_text - 1:], caches, pos)
    np.testing.assert_allclose(logits_par, logits_dec.numpy(), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_generation_equals_the_reference(models, arch):
    """The reference's ``GenerationEngine`` and the port's on the same
    weights and batch give the same tokens: a VLM decodes from
    ``S + n_patches``, an encoder-decoder beside its cross caches."""
    cfg, jm, jp, tm, tp = models(arch)
    batch = {k: np.asarray(v) for k, v in jbatch(cfg, 16, 3, "prefill", seed=5).items()}
    cache_len = 16 + 6  # a VLM's 16 positions hold its patches and its text
    want = JEngine(model=jm, params=jp, cache_len=cache_len).generate(batch, max_new_tokens=6)
    eng = GenerationEngine(model=tm, params=tp, cache_len=cache_len)
    got = eng.generate(batch, max_new_tokens=6)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(eng.generate(batch, max_new_tokens=6), got)
    with pytest.raises(ValueError, match="cache too small"):
        eng.generate(batch, max_new_tokens=7)


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-small"])
def test_serve_cli_draws_the_modality_inputs(arch, capsys, monkeypatch):
    """``launch/serve.py`` draws ``vision_embeds`` / ``enc_frames`` after
    the tokens from the same rng, as the reference's launcher does."""
    seen = {}
    real = GenerationEngine.generate

    def spy(self, batch, **kw):
        seen.update(batch)
        return real(self, batch, **kw)

    monkeypatch.setattr(GenerationEngine, "generate", spy)
    tserve.main(["--arch", arch, "--reduced", "--requests", "2", "--prompt-len", "8",
                 "--max-new", "3", "--device", "cpu"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out
    cfg = tconfigs.get_config(arch).reduced()
    rng = np.random.default_rng(0)
    want = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    key = "vision_embeds" if cfg.vlm else "enc_frames"
    rows = cfg.n_patches if cfg.vlm else cfg.enc_seq
    want[key] = rng.standard_normal((2, rows, cfg.d_model)).astype(np.float32)
    assert set(seen) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(seen[k]), want[k])
