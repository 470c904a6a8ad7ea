"""The port's other model families in bf16 against the reference, on the
CPU, each config ``.reduced()``: the reference's bf16 ``jax.random`` init
carried across with ``convert.lm_params_from_arrays``, the same bf16
batches.  The f32 parity of the same models is in
``tests/test_torch_families_models.py``; the tolerances are stated in the
test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.specs import make_concrete_batch as jbatch
from repro.models.lm import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch.specs import make_concrete_batch as tbatch
from repro_torch.models.lm import build_model as tbuild

from test_torch_families_models import FAMILIES, _prompt, close


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_matches_the_reference(arch):
    """bf16 weights and inputs.  The port upcasts exactly where the
    reference promotes to f32, but XLA fuses bf16 elementwise chains
    without rounding between ops where PyTorch rounds after each, so one
    bit flips here and there: hidden states (magnitude 2-4) within 0.125 of
    the reference's (four bf16 ulps) and, on average, no farther from the
    f32 forward of the same weights than the reference's own bf16 (within
    1.25x); logits (magnitude below 1) within 2e-2 at prefill and two
    decode steps.  deepseek-v3's absorbed decode has no bf16 reference on
    the CPU (XLA's CPU dot takes no bf16 x bf16 -> f32), so its decode
    logits are held to the reference's f32 decode of the same weights."""
    cfg = jconfigs.get_config(arch).reduced()
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(0), jnp.bfloat16)
    tcfg = tconfigs.get_config(arch).reduced()
    tm = tbuild(tcfg)
    tp = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jb = jbatch(cfg, 16, 2, "train", dtype=jnp.bfloat16)
    tb = tbatch(tcfg, 16, 2, "train", dtype=torch.bfloat16, device="cpu")
    h = tm.forward_train(tp, tb)
    assert h.dtype == torch.bfloat16
    want = np.asarray(jm.forward_train(jp, jb, remat=False), np.float32)
    got = h.to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.125)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    h32 = np.asarray(jm.forward_train(jp32, jbatch(cfg, 16, 2, "train"), remat=False))
    assert np.abs(got - h32).mean() <= 1.25 * np.abs(want - h32).mean()

    n_text = jb["tokens"].shape[1] - 2
    jl, jcaches = jm.prefill(jp, _prompt(jb, n_text), 24)
    tl, tcaches = tm.prefill(tp, _prompt(tb, n_text), 24)
    close(tl, jl, rtol=0, atol=2e-2)
    if cfg.mla:  # the reference's f32 decode from the same (upcast) weights
        jl, jcaches = jm.prefill(jp32, _prompt(jbatch(cfg, 16, 2, "train"), n_text), 24)
    pos = n_text + (cfg.n_patches if cfg.vlm else 0)
    for t in range(2):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jcaches = jm.decode_step(jp32 if cfg.mla else jp, jnp.asarray(tok), jcaches, pos + t)
        tl, tcaches = tm.decode_step(tp, torch.from_numpy(tok), tcaches, pos + t)
        assert tl.dtype == torch.bfloat16
        close(tl, jl, rtol=0, atol=2e-2)
