"""Tensor parallelism by heads: the port's Mamba2 mixer
(``mamba2.forward_train`` through ``hints.per_heads``) and MLA's attention
(``mla.forward_train`` and ``forward_prefill``, q, k and v split over
"model" on the head axis) on a (2, 4) ("data", "model") mesh of 8 gloo
ranks, against the reference's own layers compiled by GSPMD on 8 fake CPU
devices in a subprocess beside it (``tests/test_torch_dist.py``'s harness).

Both sides take the same NumPy-drawn params and inputs, the params on
their packages' ``param_shardings``, B = 8, S = 32:

* mamba2-370m reduced (H = 8 heads of 16, one group: each rank runs 2
  heads), with x on P("data") and on P(("data", "model")); with G = 4
  groups (each rank its own group) and G = 2 (a block within one group);
  with H = 2 heads of 64 (H % 4 != 0: every rank runs every head,
  ``hints.per_rows``); with N = 15 (in_proj's 294 columns do not split
  over 4 ranks, so the rules leave it whole).  ``forward_train``,
  ``return_state=True`` and ``forward_decode`` (``hints.per_heads`` with
  in_proj's columns and out_proj's rows kept on their "model" split).
* deepseek-v3-671b reduced (4 MLA heads, q through its LoRA, one head a
  rank; and 2 heads, H % 4 != 0: every rank runs every head):
  ``forward_train``, ``forward_prefill`` (a 48-row cache) and the
  absorbed ``forward_decode`` (on DTensor's rules).

Held: the output, the state and the caches at rtol 1e-4 / atol 1e-5
(``tests/test_torch_dist_families.py``'s bar); the grads of sum(y * g) for
a drawn g, every param's and x's, against ``jax.grad`` of the compiled
layer at rtol 1e-4 and an absolute floor of 1e-6 of the leaf's largest
grad (each sums 256 tokens' products, in another order on each side), the
mixer's on their params' placements as the layer leaves them; each rank's
scan and attention carry H/4 heads (recorded inside the layer), the block
its "model" coordinate names.  The decode: one token against a layer's
cache (MLA's 48 rows at POS) on the rules' cache layout (batch over
"data", whole over "model"), the output and both caches at the same bar,
against the reference's ``forward_decode`` compiled by GSPMD; each rank's
heads, and the weight blocks it holds, never a whole matrix gathered over
"model".
"""
import numpy as np
import pytest

from test_torch_dist import run_world

B, S, MODEL, CACHE, POS = 8, 32, 4, 48, 37
# (case, arch, config changes, x's batch axes)
MAMBA = [("mamba", "mamba2-370m", {}, "data"),
         ("mamba_rows_over_model", "mamba2-370m", {}, "data,model"),
         ("mamba_g4", "mamba2-370m", {"ssm_groups": 4}, "data"),
         ("mamba_g2", "mamba2-370m", {"ssm_groups": 2}, "data"),
         ("mamba_h2", "mamba2-370m", {"ssm_head_dim": 64}, "data"),
         ("mamba_n15", "mamba2-370m", {"ssm_state": 15}, "data")]
MLA = [("mla", "deepseek-v3-671b", {}, "data"),
       ("mla_h2", "deepseek-v3-671b", {"n_heads": 2}, "data")]
CASES = MAMBA + MLA

# NumPy draws shared by both sides: the params in a fixed order, then x
# and the cotangent g
_DRAW = f"""
import dataclasses
S, CACHE, POS = {S}, {CACHE}, {POS}
def case_cfg(arch, changes):
    return dataclasses.replace(get_config(arch).reduced(), **changes)

def draw(cfg, kind, seed):
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    def normal(shape, std, mean=0.0):
        return (rng.standard_normal(shape) * std + mean).astype(np.float32)
    if kind == "mamba":
        di, P, G, N, K = cfg.ssm_expand * d, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state, cfg.conv_kernel
        H = di // P
        C = di + 2 * G * N
        p = {{"in_proj": normal((d, 2 * di + 2 * G * N + H), d ** -0.5),
             "conv_w": normal((K, C), 0.3), "conv_b": normal((C,), 0.1),
             "A_log": normal((H,), 0.5), "dt_bias": normal((H,), 0.5, -2.0),
             "D": normal((H,), 0.5, 1.0), "norm_w": normal((di,), 0.1, 1.0),
             "out_proj": normal((di, d), di ** -0.5)}}
    else:
        H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        p = {{"w_dkv": normal((d, rkv), d ** -0.5), "kv_norm": normal((rkv,), 0.1, 1.0),
             "w_uk": normal((rkv, H, dn), rkv ** -0.5), "w_uv": normal((rkv, H, dv), rkv ** -0.5),
             "w_kr": normal((d, dr), d ** -0.5), "wo": normal((H * dv, d), (H * dv) ** -0.5),
             "w_dq": normal((d, rq), d ** -0.5), "q_norm": normal((rq,), 0.1, 1.0),
             "w_uq": normal((rq, H, dn + dr), rq ** -0.5)}}
    x = normal(({B}, {S}, d), 1.0)
    g = normal(({B}, {S}, d), 1.0)
    return p, x, g

# one token x (B, 1, d) and a layer's cache: Mamba2's state and conv window,
# or MLA's latent cache of CACHE rows (those past POS are masked, whatever
# they hold)
def draw_decode(cfg, kind, seed):
    rng = np.random.default_rng(1000 + seed)
    d = cfg.d_model
    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)
    if kind == "mamba":
        di, P, G, N = cfg.ssm_expand * d, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
        K = cfg.conv_kernel
        cache = {{"ssm": normal(({B}, di // P, N, P), 0.5),
                 "conv": normal(({B}, K - 1, di + 2 * G * N), 1.0)}}
    else:
        cache = {{"c_kv": normal(({B}, CACHE, cfg.kv_lora_rank), 1.0),
                 "k_rope": normal(({B}, CACHE, cfg.qk_rope_head_dim), 1.0)}}
    return normal(({B}, 1, d), 1.0), cache

CASES = {CASES!r}
"""

_BODY = _DRAW + """
from repro_torch.configs import get_config
from repro_torch.dist import hints
from repro_torch.dist.sharding import (NamedSharding, PartitionSpec as P, cache_shardings,
                                       device_put, param_shardings)
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.attention import mla
from repro_torch.models.mamba import mamba2
from repro_torch.train._tree import flatten_with_paths, leaves, tree_map

mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
coord = mesh.get_coordinate()
seen = {}
real_heads = mamba2.__dict__["_heads"]
real_decode = mamba2.__dict__["_decode"]
real_absorbed = mla.__dict__["_absorbed"]
real_norm = mamba_mod._gated_norm
real_per_head = hints.per_head

def heads_fn(p, x, heads, *a, **k):
    seen["block"] = (heads.lo, heads.hi)
    return real_heads.__func__(p, x, heads, *a, **k)

def gated_norm(y, z, w, eps, heads, di):
    seen["scan_width"] = int(y.shape[-1])  # the scan's output, Hl * P
    return real_norm(y, z, w, eps, heads, di)

def per_head(fn, q, k, v, *a, **kw):
    out = real_per_head(fn, q, k, v, *a, **kw)
    # the heads of q, k and v each rank attended over
    seen["attn"] = [int(t.to_local().shape[2]) for t in (q, k, v)]
    return out

def decode_fn(p, x, heads, *a, **k):
    # the heads the rank's decode runs and the weights it holds: in_proj's
    # and out_proj's blocks, gathered over "data" only
    seen["decode"] = [heads.lo, heads.hi, *p["in_proj"].shape, *p["out_proj"].shape]
    return real_decode.__func__(p, x, heads, *a, **k)

def absorbed(q_nope, q_rope, w_uk, w_uv, *a, **k):
    # the heads of the rank's query, of its blocks of w_uk and w_uv and of
    # the attention's output, and those blocks' shapes
    y = real_absorbed.__func__(q_nope, q_rope, w_uk, w_uv, *a, **k)
    seen["absorbed"] = [int(t.to_local().shape[i]) for t, i in ((q_nope, 2), (w_uk, 1),
                                                                (w_uv, 1), (y, 2))]
    seen["absorbed"] += [*w_uk.to_local().shape, *w_uv.to_local().shape]
    return y

mamba2._heads = staticmethod(heads_fn)
mamba2._decode = staticmethod(decode_fn)
mla._absorbed = staticmethod(absorbed)
mamba_mod._gated_norm = gated_norm
hints.per_head = per_head

def every_rank(vals):
    mine = torch.tensor([coord[0], coord[1], *vals])
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return torch.stack(out).numpy()

pos = torch.arange(S)
for seed, (name, arch, changes, on) in enumerate(CASES):
    cfg = case_cfg(arch, changes)
    kind = "mamba" if name.startswith("mamba") else "mla"
    p, x, g = draw(cfg, kind, seed)
    p = tree_map(torch.from_numpy, p)
    ps = param_shardings(p, mesh, cfg)
    rows = NamedSharding(mesh, P(tuple(on.split(","))))

    def run(train):
        sp = tree_map(lambda t: t.requires_grad_(True), device_put(p, ps))
        sx = device_put(torch.from_numpy(x), rows).requires_grad_(True)
        seen.clear()
        with hints.activation_sharding(mesh):
            if kind == "mamba":
                out = mamba2.forward_train(sp, sx, cfg, cfg.d_model, return_state=not train)
            elif train:
                out = mla.forward_train(sp, sx, cfg, pos)
            else:
                out = mla.forward_prefill(sp, sx, cfg, pos, CACHE)
            if train:
                (out * device_put(torch.from_numpy(g), rows)).sum().backward()
        return sp, sx, out

    sp, sx, y = run(True)
    out[name + "|y"] = y.full_tensor().detach().numpy()
    out[name + "|dx"] = sx.grad.full_tensor().numpy()
    for (path, t), s in zip(flatten_with_paths(sp), leaves(ps)):
        pname = "/".join(str(k) for k in path)
        out[name + "|d" + pname] = t.grad.full_tensor().numpy()
        if kind == "mamba":  # per_heads gives every grad back on its param's layout
            assert tuple(t.grad.placements) == s.placements, (name, pname, t.grad.placements)
    if kind == "mamba":
        out[name + "|ranks"] = every_rank([*seen["block"], seen["scan_width"]])
    else:
        out[name + "|ranks"] = every_rank(seen["attn"])
    _, _, (y, state) = run(False)
    out[name + "|y_state"] = y.full_tensor().detach().numpy()
    for key, t in state.items():
        out[name + "|state_" + key] = t.full_tensor().detach().numpy()

    # one decode step, the cache on the rules' layout of a layer's slice
    x1, cache = draw_decode(cfg, kind, seed)
    lead = cache_shardings({k: torch.empty((1,) + v.shape, device="meta")
                            for k, v in cache.items()}, mesh, cfg)
    cs = {k: NamedSharding(mesh, P(*s.spec[1:])) for k, s in lead.items()}
    sc = device_put(tree_map(torch.from_numpy, cache), cs)
    sp, sx1 = device_put(p, ps), device_put(torch.from_numpy(x1), rows)
    seen.clear()
    with torch.no_grad(), hints.activation_sharding(mesh):
        if kind == "mamba":
            y1, sc2 = mamba2.forward_decode(sp, sx1, cfg, sc, cfg.d_model)
        else:
            y1, sc2 = mla.forward_decode(sp, sx1, cfg, sc, POS)
    out["decode/" + name + "|y"] = y1.full_tensor().numpy()
    for key, t in sc.items():  # written in place, on its layout
        assert sc2[key].to_local().data_ptr() == t.to_local().data_ptr(), key
        assert tuple(t.placements) == cs[key].placements, key
        out["decode/" + name + "|cache_" + key] = t.full_tensor().numpy()
    out["decode/" + name + "|ranks"] = every_rank(seen["decode" if kind == "mamba" else "absorbed"])
    mark(name)
"""

_REF_BODY = _DRAW + """
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.dist.sharding import cache_shardings, param_shardings
from repro.models.attention import mla
from repro.models.mamba import mamba2

mesh = jax.make_mesh((2, 4), ("data", "model"))
pos = jnp.arange(S)
for seed, (name, arch, changes, on) in enumerate(CASES):
    cfg = case_cfg(arch, changes)
    kind = "mamba" if name.startswith("mamba") else "mla"
    p, x, g = draw(cfg, kind, seed)
    p = jax.tree_util.tree_map(jnp.asarray, p)
    ps = param_shardings(p, mesh, cfg)
    rows = NamedSharding(mesh, P(tuple(on.split(","))))
    if kind == "mamba":
        train = lambda p, x: mamba2.forward_train(p, x, cfg, cfg.d_model)
        state = lambda p, x: mamba2.forward_train(p, x, cfg, cfg.d_model, return_state=True)
    else:
        train = lambda p, x: mla.forward_train(p, x, cfg, pos)
        state = lambda p, x: mla.forward_prefill(p, x, cfg, pos, CACHE)
    out[name + "|y"] = np.asarray(jax.jit(train, in_shardings=(ps, rows))(p, x))
    grads = jax.jit(jax.grad(lambda p, x: (train(p, x) * g).sum(), argnums=(0, 1)),
                    in_shardings=(ps, rows))(p, x)
    out[name + "|dx"] = np.asarray(grads[1])
    for path, t in jax.tree_util.tree_flatten_with_path(grads[0])[0]:
        pname = "/".join(str(getattr(k, "key", k)) for k in path)
        out[name + "|d" + pname] = np.asarray(t)
    y, st = jax.jit(state, in_shardings=(ps, rows))(p, x)
    out[name + "|y_state"] = np.asarray(y)
    for key, t in st.items():
        out[name + "|state_" + key] = np.asarray(t)

    x1, cache = draw_decode(cfg, kind, seed)
    lead = cache_shardings({k: jax.ShapeDtypeStruct((1,) + v.shape, v.dtype)
                            for k, v in cache.items()}, mesh, cfg)
    cs = {k: NamedSharding(mesh, P(*s.spec[1:])) for k, s in lead.items()}
    if kind == "mamba":
        dec = lambda p, x, c: mamba2.forward_decode(p, x, cfg, c, cfg.d_model)
    else:
        dec = lambda p, x, c: mla.forward_decode(p, x, cfg, c, POS)
    y1, c1 = jax.jit(dec, in_shardings=(ps, rows, cs))(p, x1, cache)
    out["decode/" + name + "|y"] = np.asarray(y1)
    for key, t in c1.items():
        out["decode/" + name + "|cache_" + key] = np.asarray(t)
"""


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("tp_world"), _BODY, _REF_BODY)


NAMES = [c[0] for c in CASES]


def _heads(name):
    """(H, the heads a rank computes) of a case."""
    if name.startswith("mla"):
        H = 2 if name == "mla_h2" else 4
        return H, (H if H % MODEL else H // MODEL)
    H = 128 // (64 if name == "mamba_h2" else 16)
    return H, (H if H % MODEL else H // MODEL)


@pytest.mark.parametrize("name", NAMES)
def test_tensor_parallel_layer_matches_the_reference_gspmd_layer(tp_world, name):
    got, ref = tp_world
    keys = sorted(k for k in ref if k.startswith(name + "|") and "|d" not in k)
    assert keys and {name + "|y", name + "|y_state"} <= set(keys)
    assert any("|state_" in k for k in keys)
    for key in keys:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_computes_only_its_own_heads(tp_world, name):
    got, _ = tp_world
    H, local = _heads(name)
    for data, model, *rec in got[name + "|ranks"]:
        if name.startswith("mla"):  # q, k and v of the rank's heads
            assert rec == [local] * 3, rec
            continue
        lo, hi, width = rec
        assert hi - lo == local and width == local * (128 // H)
        # the block the rank's "model" coordinate names (the fallback: all)
        assert lo == (0 if local == H else model * local)


@pytest.mark.parametrize("name", NAMES)
def test_tensor_parallel_grads_match_the_reference(tp_world, name):
    got, ref = tp_world
    names = sorted(k for k in ref if k.startswith(name + "|d"))
    assert names and sorted(k for k in got if k.startswith(name + "|d")) == names
    for key in names:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                   atol=1e-6 * np.abs(ref[key]).max(), err_msg=key)


def _in_proj_width(name):
    """in_proj's columns, 2 di + 2 G N + H, at the reduced sizes (d = 64,
    d_inner 128, N = 16 unless the case changes it)."""
    changes = dict((c[0], c[2]) for c in CASES)[name]
    H, _ = _heads(name)
    return 2 * 128 + 2 * changes.get("ssm_groups", 1) * changes.get("ssm_state", 16) + H


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_the_reference_gspmd_decode(tp_world, name):
    """One decode step against a 48-row cache at POS: the output and both
    caches (the Mamba2 state and conv window, written in place; MLA's
    latent cache with the new row) against the reference's
    ``forward_decode`` compiled by GSPMD on its ``param_shardings`` and its
    rules' cache layout."""
    got, ref = tp_world
    keys = sorted(k for k in ref if k.startswith("decode/" + name + "|"))
    assert "decode/" + name + "|y" in keys and sum("|cache_" in k for k in keys) == 2, keys
    for key in keys:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_decode_runs_each_ranks_heads_on_its_model_blocks(tp_world, name):
    """Each rank's decode runs its H/4 heads, the block its "model"
    coordinate names, on weights gathered over "data" only: the Mamba2
    decode on in_proj's (64, W/4) columns and out_proj's (32, 64) rows (the
    H % 4 != 0 fallback, ``per_rows``: every head, both whole; N = 15, W =
    294 columns that the rules leave whole: in_proj whole, of which the
    rank takes its heads' columns); MLA's query, w_uk's and w_uv's blocks
    and its attention's output on one head (2 heads of 2: every head),
    the blocks as the rules hold them, (16, 1, 16) (the data axis splits
    r_kv; DTensor gathers the activations over it, not the weights)."""
    got, _ = tp_world
    H, local = _heads(name)
    for data, model, *rec in got["decode/" + name + "|ranks"]:
        if name.startswith("mla"):
            assert rec == [local] * 4 + [16, local, 16] * 2, rec
            continue
        lo, hi, *blocks = rec
        assert hi - lo == local and lo == (0 if local == H else model * local), rec
        W, split = _in_proj_width(name), (1 if local == H else MODEL)
        assert blocks == [64, W // split if W % split == 0 else W, 128 // split, 64], (blocks, W)
