"""The LM side's mesh layer on 8 gloo ranks on the CPU against the
reference: the FSDP x TP train step, weight-stationary serving, the GPipe
schedule and elastic restore (``repro_torch.dist.sharding``, ``hints``,
``pipeline``, ``train.checkpoint.restore(shardings=)``).

One world of 8 processes (``tests/test_torch_dist.py``'s harness: a
``file://`` store under ``tmp_path``, join timeouts) runs every case, and
one reference subprocess with 8 fake devices runs the reference's
pipeline beside it; the reference's unsharded step and greedy decode run
in this process.  Each test below reads its part of that one run.  Every
rank saves the full tensors (``full_tensor()``) and the harness holds
every rank's to rank 0's.

The reference's own (2, 4) FSDP x TP step does not run: under GSPMD it
raises ``DuplicateSpecError: PartitionSpec('data', None, 'data')`` at the
embedding gather (``src/repro/models/lm.py:240``, ``params["embed"][tokens]``:
``embed`` is sharded ("model", "data") and the tokens over "data"), so
the sharded port is held to the reference's *unsharded* jitted step on
the same params.

Tolerances: the loss at rtol 1e-5 and the grad norm at rtol 1e-4
(``tests/test_torch_trainer.py``'s bars: the sharded matmuls and
all-reduces sum in other orders); the params after the step: their
difference's ``global_norm`` below 1e-3, the reference's bar, and every
element within rtol 1e-4 and atol 1e-5 x its leaf's largest |value| but
at most 1 in 10,000.  AdamW's first step moves an element by
lr g / (|g| + eps), so where g is within a few eps of 0 the f32 noise of
another summation order moves it by a good share of lr: one element of
w_down's 32,768 does so here (6e-6), and the port's unsharded step
against the reference's moves the same element as far (5e-6).  Greedy
tokens equal; the pipeline at the reference test's rtol 2e-4 / atol
2e-5; restore bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.train import checkpoint

from test_torch_dist import WORLD, run_world

ARCH = "llama3.2-3b"
PROMPT, NEW, CACHE = 8, 4, 16
N_STAGES, N_MICRO, MB, D = 8, 6, 4, 16

_BODY = f"""
from torch.distributed.tensor import Shard
from repro_torch.configs import get_config
from repro_torch.dist import hints
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.dist.sharding import (
    NamedSharding, PartitionSpec as P, batch_shardings, cache_shardings, data_axes,
    device_put, param_shardings, strip_axes)
from repro_torch.models.lm import build_model
from repro_torch.obs.meters import collective_counts
from repro_torch.train import checkpoint
from repro_torch.train._tree import flatten_with_paths, leaves
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.trainer import TrainConfig, make_train_step

root = os.environ["OUT"]
cfg = get_config("{ARCH}").reduced()
model = build_model(cfg)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
template = model.init(torch.Generator().manual_seed(1), device="cpu")
ps = param_shardings(template, mesh, cfg)
mark("imports and set-up")

# ---- the FSDP x TP step: the reference's params restored onto the mesh
_, params = checkpoint.restore(os.path.join(root, "params"), template, shardings=ps)
for p, s in zip(leaves(params), leaves(ps)):
    assert tuple(p.placements) == s.placements
oc = OptConfig(warmup_steps=0)
opt = device_put(opt_init(template, oc),
                 {{"mu": ps, "nu": ps, "step": NamedSharding(mesh, P())}})
b = dict(np.load(os.path.join(root, "batch.npz")))
b = device_put({{k: torch.from_numpy(v) for k, v in b.items()}},
               batch_shardings(b, mesh))
with hints.activation_sharding(mesh):
    params, opt, m = make_train_step(model, TrainConfig(opt=oc))(params, opt, b)
for p, mu, nu, s in zip(leaves(params), leaves(opt["mu"]), leaves(opt["nu"]), leaves(ps)):
    assert tuple(p.placements) == tuple(mu.placements) == tuple(nu.placements) == s.placements
for (path, p) in flatten_with_paths(params):
    out["step||" + "||".join(path)] = p.full_tensor().numpy()
out["loss"] = m["loss"].full_tensor().numpy()
out["grad_norm"] = m["grad_norm"].full_tensor().numpy()
assert int(opt["step"].full_tensor()) == 1
mark("fsdp x tp step")

# ---- weight-stationary serving: params TP-only, the caches on their specs
stationary = strip_axes(ps, data_axes(mesh))
_, sparams = checkpoint.restore(os.path.join(root, "params"), template, shardings=stationary)
tok = dict(np.load(os.path.join(root, "prompt.npz")))["tokens"]
with torch.no_grad(), hints.activation_sharding(mesh):
    bt = {{"tokens": torch.from_numpy(tok)}}
    logits, caches = model.prefill(sparams, device_put(bt, batch_shardings(bt, mesh)), {CACHE})
    caches = device_put(caches, cache_shardings(caches, mesh, cfg))
    toks = [logits.full_tensor().argmax(-1)]
    for t in range({NEW}):
        logits, caches = model.decode_step(sparams, toks[-1][:, None], caches, {PROMPT} + t)
        toks.append(logits.full_tensor().argmax(-1))
out["tokens"] = torch.stack(toks, 1).numpy()
mark("weight-stationary prefill and decode")

# ---- the pipeline on an 8-stage ring
pipe = make_mesh(({WORLD},), ("stage",), device="cpu")
ws_, x = (torch.from_numpy(a) for a in np.load(os.path.join(root, "pipe.npz")).values())
res = {{}}
counts = collective_counts(lambda: res.update(y=pipeline_apply(
    pipe, lambda w, xb: torch.tanh(xb @ w), ws_, x)))
out["pipe"] = res["y"].numpy()
out["pipe_counts"] = np.array([counts.get("ppermute", 0), counts.get("psum", 0)])
try:
    pipeline_apply(pipe, lambda w, xb: xb, ws_[:4], x)
except ValueError as e:
    assert "must all equal the 'stage' axis size" in str(e)
else:
    raise AssertionError("a stage stack of 4 on 8 ranks did not raise")
mark("pipeline")

# ---- elastic restore onto an (8,) data mesh
dm = make_mesh(({WORLD},), ("data",), device="cpu")
w0 = {{"w": torch.zeros((8, 8))}}
step, rest = checkpoint.restore(os.path.join(root, "ck"), w0,
                                shardings={{"w": NamedSharding(dm, P("data", None))}})
assert step == 1 and tuple(rest["w"].placements) == (Shard(0),)
assert torch.equal(rest["w"].to_local(),
                   torch.arange(64, dtype=torch.float32).reshape(8, 8)[rank:rank + 1])
out["restored"] = rest["w"].full_tensor().numpy()
mark("elastic restore")
"""

_REF = f"""
from repro.dist.pdx_sharded import collective_counts
from repro.dist.pipeline import pipeline_apply

ws, x = (jnp.asarray(a) for a in np.load(os.path.join(os.environ["OUT"], "pipe.npz")).values())
mesh = jax.make_mesh(({WORLD},), ("stage",))
fn = lambda w, xb: jnp.tanh(xb @ w)
out["pipe"] = np.asarray(pipeline_apply(mesh, fn, ws, x))
c = collective_counts(lambda a, b: pipeline_apply(mesh, fn, a, b), ws, x)
out["pipe_counts"] = np.array([c.get("ppermute", 0), c.get("psum", 0)])
"""


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    """One run of the world and of the reference -> (the world's rank-0
    results, the reference subprocess's, the reference's step, its greedy
    tokens, the pipeline's inputs)."""
    root = tmp_path_factory.mktemp("lm_world")
    cfg = jconfigs.get_config(ARCH).reduced()
    jm = jlm.build_model(cfg)
    jp = jm.init(jax.random.key(0))
    checkpoint.save(str(root / "params"), 0, lm_params_from_arrays(
        tconfigs.get_config(ARCH).reduced(), jax.tree.map(np.asarray, jp), device="cpu"))
    batch = JTokenStream(cfg, 16, 4, seed=0).batch_at(0)
    np.savez(root / "batch.npz", **batch)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (4, PROMPT)).astype(np.int32)
    np.savez(root / "prompt.npz", tokens=prompt)
    ws = jax.random.normal(jax.random.key(0), (N_STAGES, D, D)) * 0.3
    x = jax.random.normal(jax.random.key(1), (N_MICRO, MB, D))
    np.savez(root / "pipe.npz", ws=np.asarray(ws), x=np.asarray(x))
    checkpoint.save(str(root / "ck"), 1, {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)})

    got, ref = run_world(root, _BODY, _REF)

    oc = jopt.OptConfig(warmup_steps=0)
    step = jax.jit(jtrainer.make_train_step(jm, jtrainer.TrainConfig(opt=oc)))
    jp2, _, jmet = step(jp, jopt.opt_init(jp, oc), {k: jnp.asarray(v) for k, v in batch.items()})
    logits, caches = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, CACHE)
    toks = [jnp.argmax(logits, -1)]
    for t in range(NEW):
        logits, caches = jm.decode_step(jp, toks[-1][:, None], caches, PROMPT + t)
        toks.append(jnp.argmax(logits, -1))
    want = {"params": jp2, "metrics": jmet, "tokens": np.asarray(jnp.stack(toks, 1))}
    return got, ref, want, (np.asarray(ws), np.asarray(x))


def test_fsdp_tp_step_matches_the_reference_unsharded_step(lm_world):
    """The (2, 4) ("data", "model") FSDP x TP step of llama3.2-3b reduced on
    ``TokenStream(cfg, 16, 4, seed=0)``, as ``tests/test_dist.py::
    test_gspmd_train_step_8dev_fsdp_tp`` sets it up (AdamW, no warmup):
    params, optimizer state and batch as DTensors through
    ``param_shardings`` / ``batch_shardings``, the hints active.  Every
    grad came back on its param's placements (asserted on each rank)."""
    got, _, want, _ = lm_world
    np.testing.assert_allclose(got["loss"], float(want["metrics"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(want["metrics"]["grad_norm"]),
                               rtol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path(want["params"])[0]
    assert sorted(k for k in got if k.startswith("step||")) == sorted(
        "step||" + "||".join(str(p.key) for p in path) for path, _ in flat)
    sq, off, n = 0.0, 0, 0
    for path, w in flat:
        key = "step||" + "||".join(str(p.key) for p in path)
        w = np.asarray(w)
        d = np.abs(got[key] - w)
        off += int((d > 1e-4 * np.abs(w) + 1e-5 * np.abs(w).max()).sum())
        n += w.size
        sq += float(np.sum(d.astype(np.float64) ** 2))
    assert np.sqrt(sq) < 1e-3
    assert off <= 1e-4 * n, (off, n)


def test_weight_stationary_decode_gives_the_reference_greedy_tokens(lm_world):
    """Params under ``strip_axes(param_shardings(...), data_axes(mesh))``
    (tensor-parallel only), the batch over "data", the prefill's caches
    put on ``cache_shardings``: prefill and 4 greedy decode steps give the
    reference's tokens."""
    got, _, want, _ = lm_world
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_pipeline_matches_the_reference(lm_world):
    """``tests/test_dist.py::test_pipeline_parallel_matches_sequential`` on
    8 ranks: the same stage weights and microbatches, the reference's
    pipeline on 8 fake devices and the stages in sequence; the port issues
    the reference's collectives, n_micro + n_stages - 1 ppermutes and one
    psum, and a stage stack of the wrong size raises."""
    got, ref, _, (ws, x) = lm_world
    np.testing.assert_allclose(got["pipe"], ref["pipe"], rtol=2e-4, atol=2e-5)
    seq = x
    for s in range(N_STAGES):
        seq = np.tanh(seq @ ws[s])
    np.testing.assert_allclose(got["pipe"], seq, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got["pipe_counts"], ref["pipe_counts"])
    np.testing.assert_array_equal(got["pipe_counts"], [N_MICRO + N_STAGES - 1, 1])


def test_elastic_restore_onto_a_data_mesh(lm_world):
    """``tests/test_dist.py::test_elastic_checkpoint_restore_onto_mesh``: an
    (8, 8) checkpoint written whole, restored onto an (8,) "data" mesh
    with spec ("data", None): rank r holds row r under ``Shard(0)``
    (asserted on each rank), and the whole tensor is the saved one."""
    got, _, _, _ = lm_world
    np.testing.assert_array_equal(got["restored"],
                                  np.arange(64, dtype=np.float32).reshape(8, 8))
