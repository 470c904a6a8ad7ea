"""Expert parallelism: the port's MoE layer on a (2, 4) ("data", "model")
mesh of 8 gloo ranks (``moe_ffn._on_mesh`` through ``hints.per_experts``)
against the reference's own sharded layer, ``moe_ffn.forward`` compiled by
GSPMD on 8 fake CPU devices in a subprocess beside it
(``tests/test_torch_dist.py``'s harness).

Both sides take the same NumPy-drawn params and inputs: the params on
their packages' ``param_shardings`` (the routed experts' expert axis over
"model", d over "data"), at B = 8 with S = 16 and S = 64, for
deepseek-moe-16b and deepseek-v3-671b reduced (E = 8, top-2, a shared
expert; v3 with its aux-free bias), at the config's capacity factor and at
0.5, where queues overflow, with x on P("data") (each "model" group routes
the same rows and sums its blocks' shares) and on P(("data", "model")):
at S = 64 each rank routes its own 2 groups and exchanges them with its
group's expert ranks by an all-to-all each way; at S = 16 (4 groups) the
rows are gathered over "model" first.  Held:

* the output at rtol 1e-4 / atol 1e-5 (``tests/test_torch_dist_families.py``'s
  bar), and the pairs dropped equal to the reference's routing of the
  whole batch;
* each rank's expert tensors in the forward are the block of E/m = 2
  experts its "model" coordinate names, the exchange is taken where the
  rows allow it, and no all-gather brings an expert tensor whole: each
  rank's all-gathers move less than the routed experts' bytes;
* the grads of sum(y * g) for a drawn g: every param's and x's against
  ``jax.grad`` of the compiled layer at rtol 1e-4 and an absolute floor of
  1e-6 of the leaf's largest grad (each sums 128 or 512 tokens' products,
  in another order on each side), the routed params' on their placements
  as the layer's backward leaves them.
"""
import numpy as np
import pytest

from test_torch_dist import run_world

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b"]
SEQS = [16, 64]
FACTORS = [None, 0.5]  # None: the config's capacity factor
ROWS = ["data", "data,model"]  # the mesh axes x's batch dim splits over
B, MODEL = 8, 4
CASES = [(a, s, f, r) for a in ARCHS for s in SEQS for f in FACTORS for r in ROWS]

# NumPy draws shared by both sides: the params in a fixed order, then x
# and the cotangent g
_DRAW = f"""
import dataclasses
def draw(cfg, seed):
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)
    p = {{"router": normal((d, E), d ** -0.5), "w_gate": normal((E, d, f), d ** -0.5),
         "w_up": normal((E, d, f), d ** -0.5), "w_down": normal((E, f, d), f ** -0.5)}}
    if cfg.router_aux_free:
        p["router_bias"] = normal((E,), 0.05)
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = {{"w_gate": normal((d, fs), d ** -0.5),
                       "w_up": normal((d, fs), d ** -0.5),
                       "w_down": normal((fs, d), fs ** -0.5)}}
    x = normal(({B}, S, d), 1.0)
    g = normal(({B}, S, d), 1.0)
    return p, x, g

def case_cfg(arch, factor):
    cfg = get_config(arch).reduced()
    return cfg if factor is None else dataclasses.replace(cfg, capacity_factor=factor)

CASES = {CASES!r}
"""

_BODY = _DRAW + """
import math
from repro_torch.configs import get_config
from repro_torch.dist import hints
from repro_torch.dist.sharding import NamedSharding, PartitionSpec as P, device_put, param_shardings
from repro_torch.launch.analysis import memory_trace
from repro_torch.models.moe import moe_ffn
from repro_torch.train._tree import flatten_with_paths, leaves, tree_map

mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
coord = mesh.get_coordinate()
real_routed = moe_ffn.__dict__["routed"]
real_dispatch = moe_ffn.__dict__["dispatch"]
seen = {}

def routed(p, x, cfg, groups=None, first=0, a2a=None):
    El = p["w_gate"].shape[0]
    seen["rows"] = [int(p[k].shape[0]) for k in ("w_gate", "w_up", "w_down")]
    # the block this rank's "model" coordinate names, whole
    lo = coord[1] * El
    seen["own"] = int(all(torch.equal(p[k], full[k][lo:lo + El])
                          for k in ("w_gate", "w_up", "w_down")))
    seen["exchange"] = int(a2a is not None)
    return real_routed.__func__(p, x, cfg, groups, first, a2a)

def dispatch(top_idx, C, n_experts):
    slot, order, keep = real_dispatch.__func__(top_idx, C, n_experts)
    seen["drops"] = int((~keep).sum())
    return slot, order, keep

moe_ffn.routed, moe_ffn.dispatch = staticmethod(routed), staticmethod(dispatch)
for arch, S, factor, on in CASES:
    key = f"{arch}|{S}|{factor}|{on}"
    cfg = case_cfg(arch, factor)
    p, x, g = draw(cfg, S)
    p = full = tree_map(torch.from_numpy, p)
    ps = param_shardings(p, mesh, cfg)
    sp = tree_map(lambda t: t.requires_grad_(True), device_put(p, ps))
    rows = NamedSharding(mesh, P(tuple(on.split(","))))
    sx = device_put(torch.from_numpy(x), rows).requires_grad_(True)
    sg = device_put(torch.from_numpy(g), rows)
    with hints.activation_sharding(mesh):
        y, coll, _ = memory_trace(lambda: moe_ffn.forward(sp, sx, cfg))
        (y * sg).sum().backward()
    out[key + "|y"] = y.full_tensor().detach().numpy()
    out[key + "|dx"] = sx.grad.full_tensor().numpy()
    for (path, t), s in zip(flatten_with_paths(sp), leaves(ps)):
        name = "/".join(str(k) for k in path)
        if t.grad is None:  # the aux-free bias only picks experts
            out[key + "|d" + name] = np.zeros(tuple(t.shape), np.float32)
            continue
        out[key + "|d" + name] = t.grad.full_tensor().numpy()
        # the routed leaves' grads come back on their params' placements
        # from the layer itself (the shared expert's from the trainer)
        if not name.startswith("shared"):
            assert tuple(t.grad.placements) == s.placements, (key, name, t.grad.placements)
    # every rank's (data, model) coordinate, expert rows, whether they are
    # its own block, whether it exchanged, its drops
    mine = torch.tensor([coord[0], coord[1], *seen["rows"], seen["own"], seen["exchange"],
                         seen["drops"]])
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    out[key + "|ranks"] = torch.stack(every).numpy()
    gathered = torch.tensor([coll["bytes"].get("all-gather", 0.0)], dtype=torch.float64)
    every = [torch.empty_like(gathered) for _ in range(dist.get_world_size())]
    dist.all_gather(every, gathered)
    out[key + "|gathered"] = torch.cat(every).numpy()
    out[key + "|experts_bytes"] = np.array(
        [4.0 * sum(p[k].numel() for k in ("w_gate", "w_up", "w_down"))])
    mark(key)
"""

_REF_BODY = _DRAW + """
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.dist.sharding import param_shardings
from repro.models.moe import moe_ffn, pick_group_count

mesh = jax.make_mesh((2, 4), ("data", "model"))

def drops(p, x, cfg):
    # the reference layer's routing lines (moe.py), on the whole batch
    Bx, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = pick_group_count(Bx * S, E, k)
    Sg = Bx * S // G
    logits = jnp.einsum("gsd,de->gse", x.reshape(G, Sg, d), p["router"]).astype(jnp.float32)
    select = logits + p["router_bias"] if cfg.router_aux_free else logits
    _, top_idx = jax.lax.top_k(select, k)
    C = int(Sg * k * cfg.capacity_factor / E) + 1
    C = min(max(8, ((C + 7) // 8) * 8), Sg * k)
    se = jnp.sort(top_idx.reshape(G, -1), axis=-1)
    pos = jnp.arange(se.shape[-1]) - jax.vmap(
        lambda s: jnp.searchsorted(s, s, side="left"))(se)
    return int((pos >= C).sum())

for arch, S, factor, on in CASES:
    key = f"{arch}|{S}|{factor}|{on}"
    cfg = case_cfg(arch, factor)
    p, x, g = draw(cfg, S)
    p = jax.tree_util.tree_map(jnp.asarray, p)
    ps = param_shardings(p, mesh, cfg)
    rows = NamedSharding(mesh, P(tuple(on.split(","))))
    fwd = jax.jit(lambda p, x: moe_ffn.forward(p, x, cfg), in_shardings=(ps, rows))
    y = fwd(p, x)
    grads = jax.jit(jax.grad(lambda p, x: (moe_ffn.forward(p, x, cfg) * g).sum(),
                             argnums=(0, 1)), in_shardings=(ps, rows))(p, x)
    out[key + "|y"] = np.asarray(y)
    out[key + "|dx"] = np.asarray(grads[1])
    for path, t in jax.tree_util.tree_flatten_with_path(grads[0])[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[key + "|d" + name] = np.asarray(t)
    out[key + "|drops"] = np.array([drops(p, x, cfg)])
"""


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("ep_world"), _BODY, _REF_BODY)


def _key(arch, S, factor, on):
    return f"{arch}|{S}|{factor}|{on}"


def _exchanges(S, on):
    """Whether the case takes the all-to-all: the rows split over "model"
    too and into whole groups on all 8 ranks (S = 64: 16 groups)."""
    return on == "data,model" and S == 64


@pytest.mark.parametrize("arch,S,factor,on", CASES)
def test_expert_parallel_layer_matches_the_reference_gspmd_layer(ep_world, arch, S, factor, on):
    got, ref = ep_world
    key = _key(arch, S, factor, on)
    np.testing.assert_allclose(got[key + "|y"], ref[key + "|y"], rtol=1e-4, atol=1e-5)
    ranks = got[key + "|ranks"]  # (data, model, rows x 3, own, exchange, drops) per rank
    # where the ranks of one "model" group route the same rows, each data
    # rank's drops count once; after an exchange every rank's rows are its own
    counted = ranks if _exchanges(S, on) else ranks[ranks[:, 1] == 0]
    dropped = int(counted[:, -1].sum())
    assert dropped == int(ref[key + "|drops"][0])
    if factor is not None:
        assert dropped > 0  # the case exists to overflow queues


@pytest.mark.parametrize("arch,S,factor,on", CASES)
def test_each_rank_runs_only_its_own_experts(ep_world, arch, S, factor, on):
    got, _ = ep_world
    key = _key(arch, S, factor, on)
    ranks = got[key + "|ranks"]
    E = 8
    for data, model, rg, ru, rd, own, exchange, _ in ranks:
        assert (rg, ru, rd) == (E // MODEL,) * 3
        assert own == 1
        assert exchange == _exchanges(S, on)
    # the FSDP unshard of a rank's block, the router and the shared expert:
    # never the routed experts whole
    assert (got[key + "|gathered"] < got[key + "|experts_bytes"][0]).all(), \
        (got[key + "|gathered"], got[key + "|experts_bytes"])


@pytest.mark.parametrize("arch,S,factor,on", CASES)
def test_expert_parallel_grads_match_the_reference(ep_world, arch, S, factor, on):
    got, ref = ep_world
    key = _key(arch, S, factor, on)
    names = sorted(k for k in ref if k.startswith(key + "|d") and k != key + "|drops")
    assert names and sorted(k for k in got if k.startswith(key + "|d")) == names
    for name in names:
        # a grad sums B * S = 128 or 512 tokens' products in another order
        # on each side: the absolute floor follows the leaf's scale
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4,
                                   atol=1e-6 * np.abs(ref[name]).max(), err_msg=name)
