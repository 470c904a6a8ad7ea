"""The other families' blocks on DTensor: the routed MoE (run per rank on
its own batch rows, ``models/moe.py:moe_ffn._on_mesh``), MLA, Mamba2 SSD,
the hybrid stack and the encoder-decoder's cross attention, on one world of
8 gloo ranks (``tests/test_torch_dist.py``'s harness) over a (2, 4)
("data", "model") mesh.

Every rank draws the same reduced params from one seed and runs each step
twice: on plain tensors (the port's single-device path, which the
reference holds elsewhere) and sharded (params on ``param_shardings``, the
batch on ``batch_shardings``, the prefill's caches on ``cache_shardings``,
inside ``hints.activation_sharding``).  The sharded run must give the plain
run's numbers: prefill and two teacher-forced decode steps' logits at
rtol 1e-4 / atol 1e-5 and the same greedy tokens, and one train step's
loss at rtol 1e-5 and grad norm at rtol 1e-4 (``tests/test_torch_dist_lm.py``'s
bars: the sharded products and all-reduces sum in other orders), with
every grad on its param's placements.
"""
import numpy as np
import pytest

from test_torch_dist import run_world

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b", "mamba2-370m",
         "whisper-small"]
B, S, L = 8, 16, 24

_BODY = f"""
from repro_torch.configs import get_config
from repro_torch.dist import hints
from repro_torch.dist.sharding import (
    NamedSharding, PartitionSpec as P, batch_shardings, cache_shardings, device_put,
    param_shardings)
from repro_torch.launch.dryrun import OPT_KIND
from repro_torch.launch.specs import make_concrete_batch
from repro_torch.models.lm import build_model
from repro_torch.train._tree import leaves, tree_map
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.trainer import TrainConfig, make_train_step

mesh = make_mesh((2, 4), ("data", "model"), device="cpu")

def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

for arch in {ARCHS!r}:
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    ps = param_shardings(params, mesh, cfg)
    sparams = device_put(params, ps)
    batch = make_concrete_batch(cfg, {S}, {B}, "prefill", device="cpu")
    with torch.no_grad():
        logits, caches = model.prefill(params, batch, {L})
        with hints.activation_sharding(mesh):
            slogits, scaches = model.prefill(sparams, device_put(batch, batch_shardings(batch, mesh)),
                                             {L})
            scaches = device_put(scaches, cache_shardings(scaches, mesh, cfg))
        got, want = [full(slogits)], [logits]
        S0 = {S} + (cfg.n_patches if cfg.vlm else 0)
        for t in range(2):  # teacher-forced: both take the plain run's token
            tok = want[-1].argmax(-1)[:, None].to(torch.int32)
            logits, caches = model.decode_step(params, tok, caches, S0 + t)
            with hints.activation_sharding(mesh):
                slogits, scaches = model.decode_step(sparams, tok, scaches, S0 + t)
            got.append(full(slogits))
            want.append(logits)
    out[arch + "||logits"] = torch.stack(want).numpy()
    out[arch + "||slogits"] = torch.stack(got).numpy()

    oc = OptConfig(warmup_steps=0, kind=OPT_KIND.get(arch, "adamw"))
    tb = make_concrete_batch(cfg, {S}, {B}, "train", device="cpu")
    step = make_train_step(model, TrainConfig(opt=oc))
    _, _, m = step(tree_map(torch.clone, params), opt_init(params, oc), tb)
    opt = opt_init(params, oc)
    osh = tree_map(lambda leaf: NamedSharding(mesh, P()), opt)
    if "mu" in opt:
        osh["mu"], osh["nu"] = ps, ps
    with hints.activation_sharding(mesh):
        sp2, _, sm = step(sparams, device_put(opt, osh),
                          device_put(tb, batch_shardings(tb, mesh)))
    for p, s in zip(leaves(sp2), leaves(ps)):
        assert tuple(p.placements) == s.placements, arch
    out[arch + "||train"] = np.array([float(m["loss"]), float(m["grad_norm"])])
    out[arch + "||strain"] = np.array([float(full(sm["loss"])), float(full(sm["grad_norm"]))])
    mark(arch)
"""


@pytest.fixture(scope="module")
def families_world(tmp_path_factory):
    got, _ = run_world(tmp_path_factory.mktemp("families_world"), _BODY)
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_family_matches_its_plain_run(families_world, arch):
    got = families_world
    np.testing.assert_allclose(got[arch + "||slogits"], got[arch + "||logits"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[arch + "||slogits"].argmax(-1),
                                  got[arch + "||logits"].argmax(-1))
    (loss, gnorm), (sloss, sgnorm) = got[arch + "||train"], got[arch + "||strain"]
    np.testing.assert_allclose(sloss, loss, rtol=1e-5)
    np.testing.assert_allclose(sgnorm, gnorm, rtol=1e-4)
