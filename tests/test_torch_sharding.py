"""The port's sharding rules (``repro_torch.dist.sharding``) and production
meshes (``repro_torch.launch.mesh``) against the reference's
(``repro.dist.sharding``, ``tests/test_sharding_rules.py`` mirrored), on
the CPU.

The rules are pure functions of names and shapes: for every param and
decode-cache leaf of every registered config, reduced and at full width,
the port's ``param_pspec`` / ``cache_pspecs`` and the divisibility guard
give the reference's specs entry for entry on the test, production and
multi-pod mesh shapes (duck-typed meshes, as the reference's tests use).
DTensor placements are checked on a gloo world of one in this process
and, for the (16, 16) and (2, 16, 16) production meshes, in a subprocess
on a fake process group of 256 or 512 ranks, where llama3.2-3b's
full-width params (meta tensors) take the shard shapes the reference's
specs imply.
"""
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.dist import sharding as jsh
from repro.models.lm import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models.lm import build_model as tbuild
from repro_torch.train._tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
MESHES = {
    "test": {"data": 2, "model": 4},
    "single_pod": {"data": 16, "model": 16},
    "multi_pod": {"pod": 2, "data": 16, "model": 16},
    "data8": {"data": 8},
}


class FakeMesh:
    """Duck-typed mesh with a ``.shape`` mapping (no device init needed)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _jkey(path) -> str:
    return "||".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _tkey(path) -> str:
    return "||".join(str(p) for p in path)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _cfgs(arch: str, scale: str):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    return (jc.reduced(), tc.reduced()) if scale == "reduced" else (jc, tc)


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process, torn down after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_public_names_are_the_references():
    assert tsh.__all__ == jsh.__all__
    assert tmesh.__all__ == ["make_production_mesh", "MESH_SHAPES"]
    from repro.launch import mesh as jmesh

    assert tmesh.MESH_SHAPES == jmesh.MESH_SHAPES
    assert tsh.DATA_AXES == jsh.DATA_AXES


@pytest.mark.parametrize("scale", ["reduced", "full"])
@pytest.mark.parametrize("arch", tconfigs.list_configs())
def test_param_specs_match_the_reference(arch, scale):
    """Every param leaf: the unguarded rule, then the guard on each mesh."""
    jcfg, tcfg = _cfgs(arch, scale)
    jshapes = jax.eval_shape(lambda k: jbuild(jcfg).init(k), jax.random.key(0))
    want = {_jkey(p): (p, leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    with torch.device("meta"):
        tparams = tbuild(tcfg)._draw(torch.Generator(), torch.float32)
    got = {_tkey(p): (p, leaf) for p, leaf in flatten_with_paths(tparams)}
    assert got.keys() == want.keys()
    meshes = {name: FakeMesh(shape) for name, shape in MESHES.items()}
    for key, (path, leaf) in got.items():
        jpath, jleaf = want[key]
        assert tuple(leaf.shape) == tuple(jleaf.shape), key
        spec = tsh.param_pspec(path, leaf, tcfg)
        jspec = jsh.param_pspec(jpath, jleaf, jcfg)
        assert tuple(spec) == tuple(jspec), (key, spec, jspec)
        for name, mesh in meshes.items():
            g = tsh._divisible(spec, tuple(leaf.shape), mesh)
            w = jsh._divisible(jspec, tuple(jleaf.shape), mesh)
            assert tuple(g) == tuple(w), (key, name, g, w)


@pytest.mark.parametrize("arch", tconfigs.list_configs())
def test_cache_specs_match_the_reference(arch):
    """Every decode-cache leaf (batch 16, so the data axes divide it), on
    every mesh; an encoder stack's ``None`` stays ``None``."""
    jcfg, tcfg = _cfgs(arch, "reduced")
    jcaches = jax.eval_shape(lambda: jbuild(jcfg).init_caches(16, 32))
    tcaches = tbuild(tcfg).init_caches(16, 32, device="meta")
    assert [c is None for c in tcaches] == [c is None for c in jcaches]
    for name, shape in MESHES.items():
        mesh = FakeMesh(shape)
        want = {_jkey(p): s for p, s in jax.tree_util.tree_flatten_with_path(
            jsh.cache_pspecs(jcaches, mesh, jcfg), is_leaf=lambda x: isinstance(x, JP))[0]}
        specs = tsh.cache_pspecs(tcaches, mesh, tcfg)
        got = {_tkey(p): _at(specs, p) for p, leaf in flatten_with_paths(tcaches)
               if leaf is not None}
        assert got.keys() == want.keys(), (name, sorted(got), sorted(want))
        for key, spec in got.items():
            assert tuple(spec) == tuple(want[key]), (name, key, spec, want[key])


def test_column_row_pairing():
    """``tests/test_sharding_rules.py::test_column_row_pairing``."""
    cfg = tconfigs.get_config("llama3.2-3b")
    wq = torch.empty((28, 3072, 3072), device="meta")
    assert tsh.param_pspec(("stack0", "sub0", "wq"), wq, cfg) == (None, "data", "model")
    assert tsh.param_pspec(("stack0", "sub0", "wo"), wq, cfg) == (None, "model", "data")
    emb = torch.empty((128256, 3072), device="meta")
    assert tsh.param_pspec(("embed",), emb, cfg) == ("model", "data")


def test_divisibility_guard_and_batch_specs_match_the_reference():
    """``tests/test_sharding_rules.py``'s guard and batch cases, and a
    sweep of both functions against the reference's."""
    P = tsh.PartitionSpec
    mesh = FakeMesh({"data": 16, "model": 16})
    assert tsh._divisible(P("data", "model"), (896, 896), mesh) == ("data", "model")
    assert tsh._divisible(P("data", "model"), (896, 14), mesh) == ("data", None)
    assert tsh._divisible(P(("data", "model"), None), (100, 4), mesh) == (None, None)
    pod = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert tsh.batch_pspec(pod, 256) == (("pod", "data"),)
    assert tsh.batch_pspec(pod, 16) == ("data",)
    assert tsh.batch_pspec(pod, 1) == ()
    specs = [(None,), ("data",), ("model", "data"), (("pod", "data"), None, "model"),
             (("data", "model"),), (("pod", "nope"), "model"), ("nope", None)]
    for shape in MESHES.values():
        m = FakeMesh(shape)
        for size in (1, 2, 4, 6, 16, 32, 256, 512, 768):
            assert tuple(tsh.batch_pspec(m, size)) == tuple(jsh.batch_pspec(m, size))
            for spec in specs:
                dims = (size,) * len(spec) + (8,)
                assert tuple(tsh._divisible(P(*spec), dims, m)) == tuple(
                    jsh._divisible(JP(*spec), dims, m)), (shape, size, spec)


def test_partition_spec_normalises_as_jax_does():
    P = tsh.PartitionSpec
    for entries in [(("data",),), ((),), (("a", "b"),), (None, "a"), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))


def test_strip_axes_and_placements_on_a_mesh(world_of_one):
    """``tests/test_sharding_rules.py::test_strip_axes_removes_data_everywhere``
    on a (1, 1) DeviceMesh, and the placements a spec gives: Shard(d) on
    the axes entry d names, Replicate elsewhere; an entry naming several
    axes shards one dim over them in the mesh's order and raises in any
    other order, or where it names an axis twice."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    P = tsh.PartitionSpec
    sh = {"w": tsh.NamedSharding(mesh, P("data", "model")),
          "b": tsh.NamedSharding(mesh, P(("data", "model"))),
          "c": None}
    out = tsh.strip_axes(sh, ("data",))
    assert out["w"].spec == (None, "model") and out["w"].mesh is mesh
    assert out["b"].spec == P(("model",)) == ("model",)
    assert out["c"] is None
    assert sh["w"].placements == (Shard(0), Shard(1))
    assert out["w"].placements == (Replicate(), Shard(1))
    assert tsh.NamedSharding(mesh, P(None, ("data", "model"))).placements == (Shard(1), Shard(1))
    assert tsh.NamedSharding(mesh, P()).placements == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tsh.placements(mesh, P(("model", "data")))
    with pytest.raises(ValueError, match="named twice"):
        tsh.placements(mesh, P("data", None, "data"))
    with pytest.raises(ValueError, match="no axis"):
        tsh.placements(mesh, P("pod"))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b", "mamba2-370m"])
def test_param_shardings_cover_full_tree(arch, world_of_one):
    """``tests/test_sharding_rules.py::test_param_shardings_cover_full_tree``:
    every leaf gets a sharding whose spec fits its rank, and ``device_put``
    lands the params as DTensors equal to them, in memory of their own."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import make_mesh
    from repro_torch.train._tree import leaves

    cfg = tconfigs.get_config(arch).reduced()
    params = tbuild(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    sh = tsh.param_shardings(params, mesh, cfg)
    assert len(leaves(sh)) == len(leaves(params))
    put = tsh.device_put(params, sh)
    for p, s, d in zip(leaves(params), leaves(sh), leaves(put)):
        assert len(s.spec) <= p.ndim
        assert isinstance(d, DTensor) and tuple(d.placements) == s.placements
        assert torch.equal(d.full_tensor(), p)
        assert d.to_local().untyped_storage().data_ptr() != p.untyped_storage().data_ptr()


def test_batch_and_cache_shardings_on_a_mesh(world_of_one):
    """``batch_shardings`` and ``cache_shardings`` give a NamedSharding per
    leaf (``None`` for an encoder stack's caches), with the specs of
    ``batch_pspec`` and ``cache_pspecs``."""
    from repro_torch.dist import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32), "step": torch.zeros(())}
    bs = tsh.batch_shardings(batch, mesh)
    assert bs["tokens"].spec == ("data",) and bs["step"].spec == ()
    cfg = tconfigs.get_config("whisper-small").reduced()
    caches = tbuild(cfg).init_caches(4, 16, device="meta")
    cs = tsh.cache_shardings(caches, mesh, cfg)
    specs = tsh.cache_pspecs(caches, mesh, cfg)
    assert cs[0] is None and specs[0] is None
    for path, leaf in flatten_with_paths(caches[1]):
        s = _at(cs[1], path)
        assert s.spec == _at(specs[1], path) and s.mesh is mesh


_PRODUCTION = """
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config
from repro_torch.dist.sharding import param_shardings
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import build_model
from repro_torch.train._tree import flatten_with_paths, leaves

multi = sys.argv[1] == "multi_pod"
world = int(sys.argv[2])
dist.init_process_group("fake", store=FakeStore(), rank=world - 1, world_size=world)
try:
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
except ValueError as e:
    print(json.dumps({"error": str(e)}))
    sys.exit(0)
cfg = get_config("llama3.2-3b")
with torch.device("meta"):
    params = build_model(cfg)._draw(torch.Generator(), torch.float32)
out = {"mesh": [list(mesh.mesh_dim_names), list(mesh.shape)], "leaves": {}}
for (path, p), s in zip(flatten_with_paths(params), leaves(param_shardings(params, mesh, cfg))):
    local = distribute_tensor(p, mesh, s.placements).to_local()
    out["leaves"]["||".join(path)] = [list(p.shape), list(local.shape)]
print(json.dumps(out))
"""


@pytest.mark.parametrize("which,world", [("single_pod", 256), ("multi_pod", 512),
                                         ("single_pod", 8)])
def test_production_mesh_shards_llama_as_the_reference_specs_imply(which, world):
    """``make_production_mesh`` on a one-process fake group of 256 or 512
    ranks builds the reference's mesh shape, and llama3.2-3b's full-width
    params (meta tensors) take on the last rank the shard shapes that the
    reference's specs imply (each dim over the product of its axes' sizes);
    a world of another size raises."""
    import json

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _PRODUCTION, which, str(world)],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    shape, axes = tmesh.MESH_SHAPES[which]
    if world != math.prod(shape):
        assert "needs a world of" in out["error"]
        return
    assert out["mesh"] == [list(axes), list(shape)]
    sizes = dict(zip(axes, shape))
    cfg = jconfigs.get_config("llama3.2-3b")
    jshapes = jax.eval_shape(lambda k: jbuild(cfg).init(k), jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    assert sorted(out["leaves"]) == sorted(_jkey(p) for p, _ in flat)
    for path, leaf in flat:
        spec = jsh._divisible(jsh.param_pspec(path, leaf, cfg), leaf.shape, FakeMesh(sizes))
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        want = [n // math.prod(sizes[a] for a in
                               (() if e is None else e if isinstance(e, tuple) else (e,)))
                for n, e in zip(leaf.shape, entries)]
        assert out["leaves"][_jkey(path)] == [list(leaf.shape), want], _jkey(path)


def test_importing_launch_mesh_touches_no_process_group():
    code = textwrap.dedent("""
        import torch.distributed as dist
        import repro_torch.launch.mesh as m
        assert not dist.is_initialized()
        try:
            m.make_production_mesh(device="cpu")
        except RuntimeError as e:
            assert "process group" in str(e)
        else:
            raise SystemExit("built a mesh without a process group")
        print("ok")
    """)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert run.returncode == 0 and "ok" in run.stdout, run.stderr
