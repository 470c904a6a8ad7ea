"""The port's loss, remat and train step against the reference's, on the CPU
(``repro_torch.models.lm`` ``chunked_ce_loss`` / ``LMModel.loss``,
``train.trainer``, ``launch.train``).

Params are the reference's ``jax.random`` init carried across with
``lm_params_from_arrays``; batches are ``TokenStream``'s, which both
packages draw alike.  The reference's steps run under ``jax.jit``, shared
per module.  Tolerances:
  * the loss: rtol 1e-5 (the port's matmuls sum in another order);
  * the grads: each leaf within rtol 1e-4 and atol 1e-5 x its largest
    |grad| (the largest gap seen is 7e-7 of that);
  * a train step (AdamW, accumulation, compression, Adafactor) over two
    steps: the ``global_norm`` of the params' difference below 1e-3, the
    reference's bar for accumulation (``tests/test_train.py``).  With
    compression a grad a hair from an int8 rounding boundary can take the
    other level, which moves its element by up to ``lr`` (1 of 156,224
    elements in the second step here): at most 1 in 10,000 elements may
    differ by more than 1e-5, the rest are held to the bar;
  * inside the port: remat on against off (every family), and a resumed
    run against the uninterrupted one, bit for bit; remat recomputes no
    product without batch dims (the reference's policy); accumulation
    against the full batch at the reference's bar (loss rtol 1e-4,
    params' difference < 1e-3); overfitting one batch drops the loss by
    more than 0.5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.train import train_loop
from repro_torch.models import lm as tlm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train._tree import leaves
from repro_torch.train.compression import ef_init
from repro_torch.train.optimizer import OptConfig, global_norm, opt_init
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step

DENSE = ("llama3.2-3b", "gemma-2b", "qwen2-72b", "granite-3-8b")
FAMILIES = ("llama3.2-3b", "deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b",
            "mamba2-370m", "internvl2-1b", "whisper-small")


def to_arrays(tree):
    return jax.tree.map(np.asarray, tree)


def setup(arch, key=0):
    """-> (ref model, ref params, port model, port params: the same numbers)."""
    jcfg = jconfigs.get_config(arch).reduced()
    jm = jlm.build_model(jcfg)
    jp = jm.init(jax.random.key(key))
    tcfg = tconfigs.get_config(arch).reduced()
    return jm, jp, tlm.build_model(tcfg), lm_params_from_arrays(tcfg, to_arrays(jp),
                                                                device="cpu")


def loss_and_grads(model, params, batch, remat=True):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, batch, remat=remat)
        # a leaf the loss does not reach (DeepSeek-V3's router bias) gets zeros
        return loss.detach(), [g.detach() for g in torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True)]
    finally:
        for p in flat:
            p.requires_grad_(False)


def close_grads(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


def params_diff(tp, jp) -> float:
    return float(jopt.global_norm(jax.tree.map(
        lambda a, b: a - b, jax.tree.map(lambda t: t.numpy(), tp), to_arrays(jp))))


# ---------------------------------------------------------------- the loss
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_the_reference(arch):
    """``tests/test_models_smoke.py::test_train_step_smoke``'s dense cases:
    ``jax.value_and_grad(model.loss)`` against the port's loss under
    autograd, on the same params and batch."""
    jm, jp, tm, tp = setup(arch)
    batch = JTokenStream(jconfigs.get_config(arch).reduced(), 32, 2, seed=1).batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, batch)
    tl, tg = loss_and_grads(tm, tp, batch)
    assert tl.shape == () and tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    close_grads(tg, jax.tree.leaves(jg))
    assert all(bool(torch.isfinite(g).all()) for g in tg)


@pytest.mark.parametrize("chunk", [512, 5, 1])
def test_chunked_ce_loss_matches_the_reference_and_the_full_logits(chunk):
    """S = 12: chunk 512 -> 12, 5 -> 4 (the divisor rule), 1 -> 1.  The
    loss and its grads (h and the head) against the reference's, and
    against ``F.cross_entropy`` over the full logits under autograd."""
    rng = np.random.default_rng(chunk)
    B, S, d, V = 2, 12, 16, 40
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    jl, (jgh, jgw) = jax.jit(jax.value_and_grad(
        lambda h, w: jlm.chunked_ce_loss(h, jnp.asarray(labels), w, chunk), argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tl = tlm.chunked_ce_loss(th, torch.from_numpy(labels), tw, chunk)
    tgh, tgw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    close_grads([tgh, tgw], [jgh, jgw])
    full = F.cross_entropy((th @ tw).reshape(-1, V), torch.from_numpy(labels).long().reshape(-1))
    fgh, fgw = torch.autograd.grad(full, (th, tw))
    np.testing.assert_allclose(float(tl.detach()), float(full.detach()), rtol=1e-5)
    close_grads([tgh, tgw], [fgh.numpy(), fgw.numpy()])


def test_the_loss_never_saves_full_logits_for_the_backward():
    """Every tensor autograd saves during ``model.loss`` (remat on, chunk
    = S) is smaller than one (B, S, V) block of logits: the loss's
    backward recomputes them.  B S = 256 > d = 64, so the logits outgrow
    the (V, d) embedding."""
    _, _, tm, tp = setup("llama3.2-3b")
    cfg = tm.cfg
    batch = TokenStream(cfg, 32, 8, seed=0).batch_at(0)
    B, S = batch["tokens"].shape
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    for p in leaves(tp):
        p.requires_grad_(True)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tm.loss(tp, batch)
        loss.backward()
    finally:
        for p in leaves(tp):
            p.requires_grad_(False)
    assert saved and max(saved) < B * S * cfg.vocab, (max(saved), B * S * cfg.vocab)


class _Products(TorchDispatchMode):
    """Counts the products of a run: ``flat`` those without batch dims
    (``mm``, ``addmm``, and a ``bmm`` or ``baddbmm`` of batch 1, which is
    what an einsum makes of one), ``batched`` the other ``bmm`` and
    ``baddbmm``."""

    def __init__(self):
        super().__init__()
        self.flat = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func._overloadpacket
        if op in (torch.ops.aten.mm, torch.ops.aten.addmm):
            self.flat += 1
        elif op in (torch.ops.aten.bmm, torch.ops.aten.baddbmm):
            lhs = args[1] if op is torch.ops.aten.baddbmm else args[0]
            if lhs.shape[0] == 1:
                self.flat += 1
            else:
                self.batched += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_remat_recomputes_no_product_without_batch_dims(arch):
    """The reference's remat policy (``dots_with_no_batch_dims_saveable``):
    the forward and backward of ``model.loss`` issue as many products
    without batch dims with remat as without (the backward recomputes none
    of them; for deepseek-v3 MLA's head projections too, which as einsums
    would be ``bmm`` of batch 1), and more batched ones (the backward
    recomputes those)."""
    _, _, tm, tp = setup(arch)
    batch = TokenStream(tm.cfg, 32, 2, seed=2).batch_at(0)
    counts = {}
    for remat in (True, False):
        with _Products() as mode:
            loss_and_grads(tm, tp, batch, remat=remat)
        counts[remat] = mode
    assert counts[True].flat == counts[False].flat > 0
    assert counts[True].batched > counts[False].batched


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_on_and_off_are_bit_for_bit(arch):
    """Checkpointing each unit under the remat policy changes neither the
    loss nor a grad, nor a train step's params, by one bit (S = 32: two
    SSD chunks, so the carried state's backward runs)."""
    _, _, tm, tp = setup(arch)
    batch = TokenStream(tm.cfg, 32, 2, seed=2).batch_at(0)
    l1, g1 = loss_and_grads(tm, tp, batch, remat=True)
    l0, g0 = loss_and_grads(tm, tp, batch, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))
    oc = OptConfig(lr=1e-2, warmup_steps=0)
    out = []
    for remat in (True, False):
        p = jax.tree.map(lambda t: t.clone(), tp)
        s = opt_init(p, oc)
        step = make_train_step(tm, TrainConfig(opt=oc, remat=remat))
        for _ in range(2):
            p, s, _ = step(p, s, batch)
        out.append(p)
    assert all(torch.equal(a, b) for a, b in zip(leaves(out[0]), leaves(out[1])))


# ------------------------------------------------------------ the train step
STEP_CASES = {
    "adamw": dict(arch="llama3.2-3b", opt=dict(lr=1e-2, warmup_steps=0)),
    "accum4": dict(arch="llama3.2-3b", opt=dict(lr=1e-3, warmup_steps=0), accum_steps=4),
    "compress": dict(arch="gemma-2b", opt=dict(lr=1e-2, warmup_steps=0), compress_grads=True),
    "adafactor": dict(arch="qwen2-72b", opt=dict(lr=2e-2, warmup_steps=1, kind="adafactor")),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_the_reference(case):
    c = dict(STEP_CASES[case])
    arch, opt = c.pop("arch"), c.pop("opt")
    jm, jp, tm, tp = setup(arch, key=3)
    jtc = jtrainer.TrainConfig(opt=jopt.OptConfig(**opt), **c)
    ttc = TrainConfig(opt=OptConfig(**opt), **c)
    jstep = jax.jit(jtrainer.make_train_step(jm, jtc))
    tstep = make_train_step(tm, ttc)
    js, ts = jopt.opt_init(jp, jtc.opt), opt_init(tp, ttc.opt)
    jextra = (jax.tree.map(lambda p: jnp.zeros(p.shape), jp),) if ttc.compress_grads else ()
    textra = (ef_init(tp),) if ttc.compress_grads else ()
    stream = TokenStream(tm.cfg, 16, 8, seed=5)
    for i in range(2):
        b = stream.batch_at(i)
        jout = jstep(jp, js, b, *jextra)
        tout = tstep(tp, ts, b, *textra)
        (jp, js, jmet), jextra = jout[:3], jout[3:]
        (tp, ts, tmet), textra = tout[:3], tout[3:]
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-4)
    if not ttc.compress_grads:
        assert params_diff(tp, jp) < 1e-3
    else:  # a grad a hair from an int8 rounding boundary may take the other level
        d = [np.abs(t.numpy() - np.asarray(j)) for t, j in zip(leaves(tp), jax.tree.leaves(jp))]
        flipped = sum(int((x > 1e-5).sum()) for x in d)
        assert flipped <= 1e-4 * sum(x.size for x in d), flipped
        assert np.sqrt(sum(float(np.sum(np.where(x > 1e-5, 0.0, x) ** 2)) for x in d)) < 1e-3
    if textra:
        ef_diff = jax.tree.map(lambda a, b: a - b, jax.tree.map(lambda t: t.numpy(), textra[0]),
                               to_arrays(jextra[0]))
        assert float(jopt.global_norm(ef_diff)) < 1e-3


def test_grad_accum_matches_full_batch():
    """``tests/test_train.py::test_grad_accum_matches_full_batch`` on the port."""
    _, _, tm, _ = setup("llama3.2-3b")
    oc = OptConfig(lr=1e-3, warmup_steps=0)
    p1, s1 = init_train_state(tm, torch.Generator().manual_seed(1), oc, device="cpu")
    p2 = jax.tree.map(lambda t: t.clone(), p1)
    s2 = opt_init(p2, oc)
    b = TokenStream(tm.cfg, 16, 8, seed=3).batch_at(0)
    p1, _, m1 = make_train_step(tm, TrainConfig(opt=oc))(p1, s1, b)
    p2, _, m2 = make_train_step(tm, TrainConfig(opt=oc, accum_steps=4))(p2, s2, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    d = global_norm(jax.tree.map(lambda a, b: a - b, p1, p2))
    assert float(d) < 1e-3
    with pytest.raises(ValueError, match="micro-batches"):
        make_train_step(tm, TrainConfig(opt=oc, accum_steps=3))(p1, opt_init(p1, oc), b)


def test_checkpoint_resume_is_bitexact(tmp_path):
    """Kill-and-restart: resumed run == uninterrupted run (the reference's
    test on the port, its bar: a difference of exactly 0)."""
    _, _, tm, _ = setup("llama3.2-3b")
    oc = OptConfig(lr=1e-2, warmup_steps=0)
    step_fn = make_train_step(tm, TrainConfig(opt=oc))
    stream = TokenStream(tm.cfg, 16, 2, seed=1)

    def run(n, params, state, start=0):
        for i in range(start, n):
            params, state, _ = step_fn(params, state, stream.batch_at(i))
        return params, state

    def fresh():
        p = tm.init(torch.Generator().manual_seed(0), device="cpu")
        return p, opt_init(p, oc)

    p_full, _ = run(6, *fresh())
    p_half, s_half = run(3, *fresh())
    root = str(tmp_path / "ck")
    ckpt.save(root, 3, {"params": p_half, "opt": s_half})
    step, restored = ckpt.restore(root, {"params": fresh()[0], "opt": fresh()[1]})
    assert step == 3 and int(restored["opt"]["step"]) == 3
    p_res, _ = run(6, restored["params"], restored["opt"], start=step)
    d = global_norm(jax.tree.map(lambda a, b: a - b, p_full, p_res))
    assert float(d) == 0.0


def test_train_loop_resumes_to_the_uninterrupted_run(tmp_path):
    """Through ``train_loop``'s own ``ckpt_dir`` resume: six steps in one
    go, against three, a restart, and three more; the step-6 checkpoints
    and the losses of steps 3-5 are equal bit for bit."""
    kw = dict(reduced=True, batch=2, seq=16, lr=1e-2, ckpt_every=3, log_every=100,
              device="cpu")
    full = train_loop("llama3.2-3b", steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    train_loop("llama3.2-3b", steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = train_loop("llama3.2-3b", steps=6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed["history"] == full["history"][3:]
    with np.load(tmp_path / "a" / "step_0000000006" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "step_0000000006" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ------------------------------------------------------------------ overfit
def _overfit_one_batch(arch, tc, steps, seq, batch, seed):
    """Fresh random tokens have an irreducible ln(vocab) loss floor, so
    convergence is asserted by overfitting one fixed batch."""
    cfg = tconfigs.get_config(arch).reduced()
    model = tlm.build_model(cfg)
    params, state = init_train_state(model, torch.Generator().manual_seed(0), tc.opt,
                                     device="cpu")
    step_fn = make_train_step(model, tc)
    b = TokenStream(cfg, seq, batch, seed=seed).batch_at(0)
    extra = (ef_init(params),) if tc.compress_grads else ()
    losses = []
    for _ in range(steps):
        out = step_fn(params, state, b, *extra)
        params, state, metrics = out[:3]
        extra = out[3:]
        losses.append(float(metrics["loss"]))
    return losses


@pytest.mark.parametrize("case", ["adamw", "compress", "adafactor"])
def test_overfitting_one_batch_drops_the_loss(case):
    """``tests/test_train.py::test_train_loop_loss_decreases`` (AdamW,
    llama), ``tests/test_system.py``'s compression (gemma-2b) and
    Adafactor cases (on a dense config: the reference's MoE one is not
    ported)."""
    args = {
        "adamw": ("llama3.2-3b", TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=0)),
                  20, 16, 4, 0),
        "compress": ("gemma-2b", TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=0),
                                             compress_grads=True), 25, 16, 2, 4),
        "adafactor": ("granite-3-8b", TrainConfig(
            opt=OptConfig(lr=2e-2, warmup_steps=0, kind="adafactor")), 25, 16, 2, 4),
    }[case]
    losses = _overfit_one_batch(*args)
    assert losses[-1] < losses[0] - 0.5, losses
