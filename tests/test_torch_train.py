"""The port's training substrate against the reference's, on the CPU:
compression, the token stream, the optimizers, checkpoints across the two
packages, the straggler monitor (``repro_torch.train``, ``data.pipeline``,
``convert.opt_state_from_arrays``).

The same NumPy inputs, drawn from a seed, go through ``repro`` and
``repro_torch``; params come from the reference's ``jax.random`` init,
carried across with ``lm_params_from_arrays``.  The reference runs as its
train step runs it, under ``jax.jit``.  Tolerances:
  * ``quantize``, ``dequantize``, ``ef_compress``, ``TokenStream``:
    bit for bit (both round half to even, both divide by the scale in
    f32 and multiply by XLA's f32 reciprocal of 127).
  * ``opt_update``, AdamW and Adafactor, over 3 steps: the ``global_norm``
    of the params' difference below 1e-3 (the reference's bar for
    gradient accumulation, ``tests/test_train.py``); the state at rtol
    1e-4 / atol 1e-7 (f32 elementwise work in another order: means, the
    bias corrections' powers), bf16 moments within one bf16 ulp (rtol
    2^-7: an f32 value a hair from a rounding boundary rounds either way).
  * Checkpoints: what one package writes the other restores bit for bit.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models.lm import build_model as jbuild
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_arrays, opt_state_from_arrays
from repro_torch.data import pipeline as tpipe
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import straggler

ARCH = "llama3.2-3b"


def to_arrays(tree):
    return jax.tree.map(np.asarray, tree)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def tree_equal(got, want):
    """Nested dicts of tensors (got) and arrays (want), equal bit for bit."""
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)),
                 to_numpy(got), to_arrays(want))


@pytest.fixture(scope="module")
def ref_params():
    cfg = jconfigs.get_config(ARCH).reduced()
    return jbuild(cfg).init(jax.random.key(0))


def port_params(ref):
    return lm_params_from_arrays(tconfigs.get_config(ARCH).reduced(), to_arrays(ref),
                                 device="cpu")


# --------------------------------------------------------------- compression
@pytest.fixture(scope="module")
def jit_comp():
    return jax.jit(jcomp.quantize), jax.jit(jcomp.dequantize), jax.jit(jcomp.ef_compress)


@pytest.mark.parametrize("log_scale", [-9, -3, 0, 2])
def test_quantize_and_dequantize_bit_for_bit(jit_comp, log_scale):
    jq, jdq, _ = jit_comp
    g = (np.random.default_rng(log_scale + 10).standard_normal(4099)
         * 10.0 ** log_scale).astype(np.float32)
    g[:3] = [0.0, -0.0, g.max() * 0.5]
    want_q, want_s = jq(jnp.asarray(g))
    got_q, got_s = tcomp.quantize(torch.from_numpy(g))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32 and got_s.ndim == 0
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_s.item() == float(want_s)
    np.testing.assert_array_equal(tcomp.dequantize(got_q, got_s).numpy(),
                                  np.asarray(jdq(want_q, want_s)))


def test_quantize_of_zeros_uses_the_floor_scale(jit_comp):
    jq, _, _ = jit_comp
    want_q, want_s = jq(jnp.zeros(5))
    got_q, got_s = tcomp.quantize(torch.zeros(5))
    assert got_s.item() == float(want_s)
    assert not got_q.any()


def test_ef_compress_bit_for_bit_over_steps(jit_comp):
    """Five steps of error feedback on a two-leaf tree, the residual
    carried: every output and residual equals the reference's."""
    _, _, jef = jit_comp
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 33), "b": {"c": (130,)}}
    jres = jax.tree.map(lambda s: jnp.zeros(s), shapes, is_leaf=lambda x: isinstance(x, tuple))
    tres = tcomp.ef_init({"a": torch.zeros(7, 33), "b": {"c": torch.zeros(130)}})
    for _ in range(5):
        g = {"a": rng.standard_normal((7, 33)).astype(np.float32) * 0.01,
             "b": {"c": rng.standard_normal(130).astype(np.float32)}}
        jout, jres = jef(jax.tree.map(jnp.asarray, g), jres)
        tout, tres = tcomp.ef_compress(
            {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(g["b"]["c"])}}, tres)
        tree_equal(tout, jout)
        tree_equal(tres, jres)


def test_quantize_roundtrip_error_bounded(rng):
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, s = tcomp.quantize(g)
    assert q.dtype == torch.int8
    err = (tcomp.dequantize(q, s) - g).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7


def test_error_feedback_preserves_signal(rng):
    """Sum of compressed grads over steps tracks sum of raw grads."""
    gs = [torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 0.01)
          for _ in range(20)]
    ef = tcomp.ef_init({"g": gs[0]})
    tot_c = np.zeros(64)
    tot_r = np.zeros(64)
    for g in gs:
        out, ef = tcomp.ef_compress({"g": g}, ef)
        tot_c += out["g"].numpy()
        tot_r += g.numpy()
    assert np.abs(tot_c + ef["g"].numpy() - tot_r).max() < 1e-4


# ------------------------------------------------------------- token stream
@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-1b", "whisper-small"])
def test_token_stream_draws_the_reference_batches(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    want = jpipe.TokenStream(jcfg, 24, 3, seed=7)
    got = tpipe.TokenStream(tcfg, 24, 3, seed=7)
    assert got.seq == want.seq
    for step in (0, 1, 17):
        w, g = want.batch_at(step), got.batch_at(step)
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def test_pipeline_deterministic_and_prefetch_places_on_the_device():
    cfg = tconfigs.get_config(ARCH).reduced()
    s1 = tpipe.TokenStream(cfg, 16, 2, seed=9)
    s2 = tpipe.TokenStream(cfg, 16, 2, seed=9)
    np.testing.assert_array_equal(s1.batch_at(5)["tokens"], s2.batch_at(5)["tokens"])
    pf = tpipe.Prefetcher(s1.iter_from(3), depth=2, place=tpipe.to_device("cpu"))
    try:
        for step in (3, 4):
            b = pf.next()
            assert isinstance(b["tokens"], torch.Tensor) and b["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(b["labels"].numpy(), s2.batch_at(step)["labels"])
    finally:
        pf.close()


def test_prefetcher_surfaces_an_iterator_error():
    def broken():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise RuntimeError("stream broke")

    pf = tpipe.Prefetcher(broken())
    pf.next()
    with pytest.raises(RuntimeError, match="stream broke"):
        pf.next()
    pf.close()


# ---------------------------------------------------------------- optimizer
def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([4.0, -3.0])}
    oc = topt.OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0)
    state = topt.opt_init(params, oc)
    val0 = float(torch.sum(params["w"] ** 2))
    for _ in range(50):
        g = {"w": 2 * params["w"]}
        params, state, _ = topt.opt_update(g, state, params, oc)
    assert float(torch.sum(params["w"] ** 2)) < val0 * 0.1
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 50


def _grads(seed, shapes_tree, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        shapes_tree)


OPT_CASES = {
    "adamw": dict(lr=1e-2, warmup_steps=2),
    "adamw_unclipped": dict(lr=1e-2, warmup_steps=0, grad_clip=1e9),
    "adamw_bf16_state": dict(lr=1e-2, warmup_steps=0, state_dtype="bf16"),
    "adafactor": dict(lr=2e-2, warmup_steps=2, kind="adafactor"),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_opt_update_matches_the_reference_over_three_steps(ref_params, case):
    kw = dict(OPT_CASES[case])
    bf16 = kw.pop("state_dtype", None) == "bf16"
    jcfg = jopt.OptConfig(**kw, state_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tcfg = topt.OptConfig(**kw, state_dtype=torch.bfloat16 if bf16 else torch.float32)
    jp, js = ref_params, jopt.opt_init(ref_params, jcfg)
    tp = port_params(ref_params)
    ts = topt.opt_init(tp, tcfg)
    assert {k: _flat(v).keys() for k, v in ts.items() if k != "step"} == {
        k: _flat(v).keys() for k, v in js.items() if k != "step"}
    jstep = jax.jit(lambda g, s, p: jopt.opt_update(g, s, p, jcfg))
    for i in range(3):
        g = _grads(i, to_arrays(jp), 0.3 if i else 1e-3)  # steps 1 and 2 clipped
        jp, js, jm = jstep(jax.tree.map(jnp.asarray, g), js, jp)
        tg = lm_params_from_arrays(tconfigs.get_config(ARCH).reduced(), g, device="cpu")
        tp2, ts, tm = topt.opt_update(tg, ts, tp, tcfg)
        assert tp2 is tp  # updated in place
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == i + 1
        tree_equal(tg, g)  # the grads are read, never written
    diff = jax.tree.map(lambda a, b: a - b, to_numpy(tp), to_arrays(jp))
    assert float(jopt.global_norm(diff)) < 1e-3
    for key in (k for k in js if k != "step"):
        want = _flat(to_arrays(js[key]))
        for name, got in _flat(ts[key]).items():
            assert got.dtype == tcfg.state_dtype or kw.get("kind") == "adafactor"
            np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                       np.asarray(want[name], np.float32),
                                       rtol=2.0 ** -7 if bf16 else 1e-4, atol=1e-7,
                                       err_msg=f"{key} {name}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_global_norm_and_clip_match_the_reference(ref_params):
    g = _grads(3, to_arrays(ref_params), 0.5)
    tg = lm_params_from_arrays(tconfigs.get_config(ARCH).reduced(), g, device="cpu")
    jn = jax.jit(jopt.global_norm)(jax.tree.map(jnp.asarray, g))
    np.testing.assert_allclose(float(topt.global_norm(tg)), float(jn), rtol=1e-6)
    jc, jcn = jax.jit(lambda t: jopt.clip_by_global_norm(t, 1.0))(jax.tree.map(jnp.asarray, g))
    tc, tcn = topt.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tcn), float(jcn), rtol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-9),
                 to_numpy(tc), to_arrays(jc))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_state_from_arrays_carries_the_reference_state(ref_params, kind):
    cfg = jopt.OptConfig(kind=kind, warmup_steps=0)
    g = jax.tree.map(jnp.asarray, _grads(1, to_arrays(ref_params), 0.1))
    _, js, _ = jax.jit(lambda g, s, p: jopt.opt_update(g, s, p, cfg))(
        g, jopt.opt_init(ref_params, cfg), ref_params)
    ts = opt_state_from_arrays(to_arrays(js), device="cpu")
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0 and int(ts["step"]) == 1
    tree_equal({k: v for k, v in ts.items() if k != "step"},
               {k: v for k, v in js.items() if k != "step"})
    with pytest.raises(ValueError, match="optimizer state keys"):
        opt_state_from_arrays({"mu": {}, "step": 0}, device="cpu")


# -------------------------------------------------------------- checkpoints
def _trained_state(ref_params):
    """A reference (params, AdamW state) after one update: a non-zero step."""
    cfg = jopt.OptConfig(warmup_steps=0)
    g = jax.tree.map(jnp.asarray, _grads(2, to_arrays(ref_params), 0.1))
    p, s, _ = jax.jit(lambda g, s, p: jopt.opt_update(g, s, p, cfg))(
        g, jopt.opt_init(ref_params, cfg), ref_params)
    return {"params": p, "opt": s}


def _port_template(ref_params):
    tp = port_params(ref_params)
    return {"params": tp, "opt": topt.opt_init(tp, topt.OptConfig())}


def test_a_reference_checkpoint_restores_in_the_port(tmp_path, ref_params):
    tree = _trained_state(ref_params)
    jckpt.save(str(tmp_path), 7, tree, meta={"arch": ARCH})
    step, got = tckpt.restore(str(tmp_path), _port_template(ref_params))
    assert step == 7
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 1
    tree_equal(got, tree)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path, ref_params):
    tree = _trained_state(ref_params)
    tp = port_params(tree["params"])
    ts = opt_state_from_arrays(to_arrays(tree["opt"]), device="cpu")
    path = tckpt.save(str(tmp_path), 3, {"params": tp, "opt": ts})
    assert os.path.basename(path) == "step_0000000003"
    step, got = jckpt.restore(str(tmp_path), tree)
    assert step == 3
    tree_equal({"params": tp, "opt": ts}, got)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert "opt||step" in z.files and "params||stack0||sub0||wq" in z.files


def test_checkpoint_roundtrip_and_retention(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": {"c": torch.ones(4)}}
    root = str(tmp_path / "ck")
    for s in [1, 2, 3, 4, 5]:
        tckpt.save(root, s, tree, keep=2)
    assert tckpt.all_steps(root) == [4, 5]
    assert tckpt.latest_step(root) == 5
    step, restored = tckpt.restore(root, tree)
    assert step == 5
    assert torch.equal(restored["a"], tree["a"]) and torch.equal(restored["b"]["c"], tree["b"]["c"])
    with pytest.raises(KeyError, match="checkpoint missing d"):
        tckpt.restore(root, {**tree, "d": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tree)


def test_checkpoint_keeps_the_template_dtype(tmp_path):
    """A bf16 leaf is written as its exact f32 values and restored to the
    template's bf16."""
    tree = {"w": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)}
    tckpt.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "step_0000000001" / "arrays.npz") as z:
        assert z["w"].dtype == np.float32
    _, got = tckpt.restore(str(tmp_path), tree)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], tree["w"])


def test_async_checkpointer_snapshots_before_the_next_update(tmp_path):
    root = str(tmp_path / "ck")
    ac = tckpt.AsyncCheckpointer(root)
    tree = {"w": torch.full((8,), 7.0)}
    ac.save(10, tree)
    tree["w"].add_(1.0)  # the next step updates the params in place
    ac.wait()
    step, restored = tckpt.restore(root, tree)
    assert step == 10
    np.testing.assert_array_equal(restored["w"].numpy(), np.full((8,), 7.0))


# --------------------------------------------------------------- straggler
def test_straggler_monitor_flags_outlier(monkeypatch):
    """The reference's test on a fake clock: ten 1 ms steps, then a 50 ms one."""
    now = [0.0]
    monkeypatch.setattr(straggler.time, "perf_counter", lambda: now[0])
    m = straggler.StepTimeMonitor(window=32, factor=2.0)
    for _ in range(10):
        m.start()
        now[0] += 0.001
        assert m.stop() == (pytest.approx(0.001), False)
    m.start()
    now[0] += 0.05
    dt, slow = m.stop()
    assert slow and m.flagged == 1 and dt == pytest.approx(0.05)
    assert m.median == pytest.approx(0.001)


def test_straggler_monitor_needs_eight_steps_before_flagging(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(straggler.time, "perf_counter", lambda: now[0])
    m = straggler.StepTimeMonitor(window=4, factor=2.0)
    for dt in (0.001,) * 7 + (1.0,):
        m.start()
        now[0] += dt
        assert not m.stop()[1]
    with pytest.raises(AssertionError, match="start"):
        m.stop()


def test_heartbeat_stale_detection(tmp_path):
    hb0 = straggler.Heartbeat(str(tmp_path), 0, timeout=1.0)
    hb1 = straggler.Heartbeat(str(tmp_path), 1, timeout=1.0)
    hb0.beat()
    hb1.beat()
    assert hb0.stale_hosts() == []
    assert hb0.stale_hosts(now=time.time() + 10_000) == [0, 1]
