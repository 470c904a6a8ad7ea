"""Rules of the PyTorch port that no parity test covers: it imports neither
JAX nor the JAX package, it never runs on the CPU unasked, it refuses
what it has not ported instead of doing something else, its kernel
wrappers never fall back to the plain versions, every registered model
family builds, and ``chip_smoke.py`` fails without a card or without the
repository beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import layout, pruners
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.data.synthetic import make_dataset
from repro_torch.index import ivf, kmeans
from repro_torch.kernels.batched_matmul import batched_distance_cuda, batched_distance_quant_cuda
from repro_torch.kernels.nary_scan import nary_distance_cuda
from repro_torch.kernels.pdx_scan import (
    pdx_distance_cuda,
    pdx_prune_scan_cuda,
    pdx_prune_scan_multi_cuda,
    pdx_prune_scan_multi_prefetch_cuda,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_module_names_jax_or_repro_in_an_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro") for n in names), (
            path, names)


def test_build_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, _ = make_dataset(64, 8, "normal", n_queries=1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorSearchEngine.build(X, pruner="linear", capacity=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VectorSearchEngine.build(X, pruner="linear", capacity=64, device="cuda")


@pytest.mark.parametrize("builder", [
    "build_flat_store", "build_bucketed_store", "build_ivf", "kmeans",
    "make_adsampling", "make_bsa", "make_bond", "engine_from_arrays",
    "build_centroid_tree", "build_ivf_tree",
])
def test_every_builder_without_device_raises_when_cuda_is_absent(monkeypatch, builder):
    """Leaving ``device`` out means the card: each builder raises without
    one instead of placing its tensors on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, _ = make_dataset(64, 8, "normal", n_queries=1, seed=0)
    calls = {
        "build_flat_store": lambda: layout.build_flat_store(X, capacity=16),
        "build_bucketed_store": lambda: layout.build_bucketed_store(
            X, np.arange(64) % 2, 2, 16),
        "build_ivf": lambda: ivf.build_ivf(X, 2, capacity=16),
        "kmeans": lambda: kmeans.kmeans(X, 2, iters=1),
        "make_adsampling": lambda: pruners.make_adsampling(8),
        "make_bsa": lambda: pruners.make_bsa(X),
        "make_bond": lambda: pruners.make_bond(X.mean(0)),
        "engine_from_arrays": lambda: convert.engine_from_arrays(
            {"pruner": "linear"}, device=None),
        "build_centroid_tree": lambda: kmeans.build_centroid_tree(X[:16], 4),
        "build_ivf_tree": lambda: ivf.build_ivf(X, 4, capacity=16, tree=True),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[builder]()


@pytest.mark.parametrize("builder", [
    "LMModel.init", "lm_params_from_arrays", "RagPipeline.build", "make_concrete_batch",
    "init_caches", "serve_main", "make_concrete_batch_vlm", "make_concrete_batch_encdec",
])
def test_every_lm_builder_without_device_raises_when_cuda_is_absent(monkeypatch, builder):
    """The LM side keeps the rule: its params, batches, caches and the RAG
    store go to the card unless ``device`` says otherwise."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.specs import make_concrete_batch
    from repro_torch.models.lm import build_model
    from repro_torch.serve import GenerationEngine, RagPipeline

    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in params.items()}
    docs = np.zeros((2, 4), np.int32)
    calls = {
        "LMModel.init": lambda: model.init(torch.Generator().manual_seed(0)),
        "lm_params_from_arrays": lambda: convert.lm_params_from_arrays(cfg, arrays),
        "RagPipeline.build": lambda: RagPipeline.build(
            GenerationEngine(model=model, params=params, cache_len=16), docs),
        "make_concrete_batch": lambda: make_concrete_batch(cfg, 8, 2, "train"),
        "init_caches": lambda: model.init_caches(2, 16),
        "serve_main": lambda: serve.main(["--arch", "whisper-small", "--reduced"]),
        "make_concrete_batch_vlm": lambda: make_concrete_batch(
            get_config("internvl2-1b").reduced(), 16, 2, "prefill"),
        "make_concrete_batch_encdec": lambda: make_concrete_batch(
            get_config("whisper-small").reduced(), 8, 2, "train"),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[builder]()


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "deepseek-v3-671b", "internvl2-1b",
                                  "jamba-v0.1-52b", "mamba2-370m", "whisper-small"])
def test_build_model_builds_every_family_at_full_width(name):
    """Every registered family builds at its published dims, and its params'
    shapes (drawn on the meta device) are those of the reference's init
    (``jax.eval_shape``, no allocation in either)."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models.lm import build_model as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    model = build_model(get_config(name))
    want = jax.eval_shape(lambda k: jbuild(jget_config(name)).init(k), jax.random.key(0))
    assert model.param_shapes() == jax.tree.map(lambda a: tuple(a.shape), want)


@pytest.mark.parametrize("entry", ["train_loop", "main", "init_train_state",
                                   "opt_state_from_arrays"])
def test_every_train_entry_point_without_device_raises_when_cuda_is_absent(
        monkeypatch, entry):
    """Training keeps the rule: ``train_loop`` (and its CLI without
    ``--device``), ``init_train_state`` and the carried-over optimizer
    state go to the card unless ``device`` says otherwise."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.lm import build_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("llama3.2-3b").reduced())
    calls = {
        "train_loop": lambda: train.train_loop("llama3.2-3b", steps=1),
        "main": lambda: train.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "1"]),
        "init_train_state": lambda: init_train_state(
            model, torch.Generator().manual_seed(0), OptConfig()),
        "opt_state_from_arrays": lambda: convert.opt_state_from_arrays(
            {"mu": {}, "nu": {}, "step": np.int32(0)}),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_elastic_restore_onto_a_mesh_names_its_roadmap_item(tmp_path):
    """``restore(shardings=...)`` raises until the FSDP x TP step is ported,
    rather than ignoring the shardings."""
    from repro_torch.train import checkpoint

    tree = {"w": torch.zeros(3)}
    checkpoint.save(str(tmp_path), 1, tree)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, modules queue item 2"):
        checkpoint.restore(str(tmp_path), tree, shardings={"w": None})


@pytest.fixture(scope="module")
def cpu_engine():
    X, Q = make_dataset(300, 12, "normal", n_queries=2, seed=1)
    return VectorSearchEngine.build(X, index="ivf", pruner="adsampling",
                                    capacity=64, nlist=4, device="cpu"), Q


def test_kernel_cuda_on_a_cpu_store_raises(cpu_engine):
    eng, Q = cpu_engine
    for q in (Q[0], Q):
        with pytest.raises(ValueError, match="kernel='cuda'"):
            eng.search(q, SearchSpec(kernel="cuda"))
    with pytest.raises(ValueError, match="kernel='cuda'"):
        eng.search(Q, SearchSpec(kernel="cuda", executor="fused-batch"))


@pytest.mark.parametrize("spec", [dict(cascade=("int8", "f32")), dict(scan_dtype="int8")])
def test_kernel_torch_refuses_kernel_executors_on_a_cuda_store(cpu_engine, monkeypatch,
                                                               spec):
    """``kernel="torch"`` steers planning only: where a cascade or fused
    executor would run on a CUDA store, the planner raises rather than run
    the plain versions on the card."""
    from repro_torch.core import plan

    eng, Q = cpu_engine
    monkeypatch.setattr(plan, "_on_cuda", lambda store: True)
    for q in (Q[0], Q):
        with pytest.raises(ValueError, match="kernel='torch'"):
            eng.plan(q, SearchSpec(kernel="torch", **spec))


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process, torn down after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec", [
    dict(executor="routed_tiered"),
    dict(executor="dim-sharded"),
    dict(executor="routed_bucket"),
    dict(executor="block-sharded"),
    dict(executor="batch-block-sharded"),
])
def test_unported_paths_name_their_roadmap_item(cpu_engine, spec):
    """Every mesh executor is ported (the two bucket-routed ones too), and
    each, forced without a mesh, names the mesh axis it needs instead of
    searching some other way."""
    eng, Q = cpu_engine
    axis = "model" if spec["executor"] == "dim-sharded" else "data"
    with pytest.raises(ValueError,
                       match=f"{spec['executor']} executor needs a mesh with a '{axis}' axis"):
        eng.search(Q, SearchSpec(**spec))


def test_unported_engine_calls_name_their_roadmap_item(cpu_engine, world_of_one):
    """An IVF engine on a "data" mesh plans the bucket-routed search at
    search, plan and build, ``routed_tiered`` with ``hbm_slots``, and a
    two-level tree's -1 pads route through it too; on a world of one each
    gives the single-device executor's ids.  ``routing="broadcast"``
    ignores the mesh with the reference's note, and a mesh that is not a
    DeviceMesh is refused as such."""
    from repro_torch.dist import make_mesh

    eng, Q = cpu_engine
    mesh = make_mesh((1,), ("data",), device="cpu")
    routed = eng.search(Q, mesh=mesh)
    assert routed.plan.executor == "routed_bucket"
    assert eng.plan(Q, mesh=mesh).executor == "routed_bucket"
    spec = SearchSpec(nprobe=eng.spec.nprobe)
    np.testing.assert_array_equal(routed.ids, eng.search(
        Q, spec.replace(executor="batch-matmul")).ids)
    tiered = eng.search(Q, SearchSpec(hbm_slots=4), mesh=mesh)
    assert tiered.plan.executor == "routed_tiered"
    np.testing.assert_array_equal(tiered.ids, eng.search(
        Q, SearchSpec(hbm_slots=4, executor="tiered-scan")).ids)
    tree = VectorSearchEngine.build(Q, index="ivf", nlist=2, tree=True, capacity=64,
                                    mesh=mesh, device="cpu")
    res = tree.search(Q)
    assert res.plan.executor == "routed_bucket"
    np.testing.assert_array_equal(res.ids, tree.search(
        Q, SearchSpec(executor="batch-matmul")).ids)
    assert eng.plan(Q, SearchSpec(routing="broadcast"), mesh=mesh).reason.startswith(
        "mesh ignored: spec.routing='broadcast'")
    with pytest.raises(TypeError, match="DeviceMesh"):
        eng.search(Q, mesh=object())
    flat = VectorSearchEngine.build(Q, pruner="linear", capacity=64, device="cpu")
    with pytest.raises(ValueError, match="unknown executor"):
        flat.search(Q[0], SearchSpec(executor="no-such-executor"))


def test_only_tiered_and_mesh_executors_remain_unported():
    """Nothing is left unported: the masked, the tiered and all five mesh
    executors are registered and ``UNPORTED_EXECUTORS`` is gone; the
    planner takes ``prefer_static`` to ``jit-masked`` on a flat store."""
    from repro_torch.core import plan

    for name in ("jit-masked", "tiered-scan", "block-sharded", "dim-sharded",
                 "batch-block-sharded", "routed_bucket", "routed_tiered"):
        assert name in plan.executor_names()
    assert not hasattr(plan, "UNPORTED_EXECUTORS")
    X, Q = make_dataset(200, 8, "normal", n_queries=1, seed=0)
    flat = VectorSearchEngine.build(X, pruner="linear", capacity=64, device="cpu")
    assert flat.search(Q[0], SearchSpec(prefer_static=True)).plan.executor == "jit-masked"


def test_make_mesh_needs_a_process_group_and_a_card_unless_asked(monkeypatch):
    """``make_mesh`` without an initialised process group raises, and so
    does ``device=None`` (the card) where no card exists; the planner
    refuses a mesh whose group is gone and a CPU store on a CUDA mesh,
    and ``kernel="cuda"`` on a CPU mesh raises as on a CPU store."""
    import torch.distributed as dist

    from repro_torch.core import plan
    from repro_torch.dist import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1,), ("data",), device="cpu")
    X, Q = make_dataset(200, 8, "normal", n_queries=2, seed=0)
    flat = VectorSearchEngine.build(X, pruner="linear", capacity=64, device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), device="cpu")
        with pytest.raises(ValueError, match="kernel='cuda'"):
            flat.search(Q, SearchSpec(kernel="cuda"), mesh=mesh)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh((1,), ("data",))
        cuda_store = SimpleNamespace(device=torch.device("cuda"))
        with pytest.raises(ValueError, match="'cpu' mesh but the store is on cuda"):
            plan._mesh_layout(mesh, cuda_store)
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="initialised default process group"):
        flat.plan(Q, mesh=mesh)


def test_tiered_entry_points_follow_the_store_and_the_kernel_knob(cpu_engine, monkeypatch):
    """``hbm_slots`` on an IVF engine plans ``tiered-scan``; its slot pool
    and tree live on the store's device; ``kernel="cuda"`` on a CPU store
    raises, and so does ``kernel="torch"`` on a CUDA store (the tiered
    executor runs K2 on the card, never the plain version)."""
    from repro_torch.core import plan

    eng, Q = cpu_engine
    res = eng.search(Q, SearchSpec(k=3, nprobe=2, hbm_slots=4, scan_dtype="int8"))
    assert res.plan.executor == "tiered-scan"
    cache = next(iter(eng.store._tiered_cache.values()))
    assert cache.device == eng.device and cache.arrays()[0].device == eng.device
    eng.ivf.attach_tree(2, 1)
    assert eng.ivf.super_centroids.device == eng.device
    eng.ivf.super_centroids = eng.ivf.super_children = None
    with pytest.raises(ValueError, match="kernel='cuda'"):
        eng.search(Q, SearchSpec(kernel="cuda", hbm_slots=4))
    monkeypatch.setattr(plan, "_on_cuda", lambda store: True)
    with pytest.raises(ValueError, match="kernel='torch'"):
        eng.plan(Q, SearchSpec(kernel="torch", hbm_slots=4))
    assert eng.plan(Q, SearchSpec(hbm_slots=4)).executor == "tiered-scan"


def test_kernel_wrappers_refuse_cpu_tensors_without_fallback():
    wrappers = (pdx_prune_scan_multi_cuda, pdx_prune_scan_multi_prefetch_cuda,
                batched_distance_quant_cuda, pdx_distance_cuda, nary_distance_cuda,
                pdx_prune_scan_cuda, batched_distance_cuda)
    before = [w.launches for w in wrappers]
    T = torch.zeros((1, 8, 16))
    f = torch.zeros(8)
    for scan in wrappers[:2]:
        with pytest.raises(ValueError, match="CUDA tensor"):
            scan(T, torch.zeros((1, 16), dtype=torch.int32), f, torch.zeros(1), f, f,
                 dim=8, d_tile=4, eps0=2.1, quantized=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        batched_distance_quant_cuda(T, torch.zeros((2, 8)), torch.zeros(2), metric="l2")
    T2 = torch.zeros((8, 16))
    for plain in (pdx_distance_cuda, nary_distance_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            plain(T2 if plain is pdx_distance_cuda else T2.T.contiguous(), f, "l2")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pdx_prune_scan_cuda(T2, None, f, torch.zeros(1), d_tile=4, eps0=2.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        batched_distance_cuda(T2, torch.zeros((2, 8)), torch.zeros(2), torch.zeros(16),
                              metric="l2")
    assert [w.launches for w in wrappers] == before


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--n", "64"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok": true' not in run.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    run = subprocess.run([sys.executable, str(alone), "--n", "64"], env=env,
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok": true' not in run.stdout


def test_search_returns_numpy_on_the_cpu(cpu_engine):
    eng, Q = cpu_engine
    res = eng.search(Q, SearchSpec(k=3))
    assert isinstance(res.ids, np.ndarray) and res.ids.shape == (2, 3)
    ids, dists = res
    assert dists.dtype == np.float32 and res.plan.executor == "adaptive"
