"""Rules of the PyTorch port that no parity test covers: it imports neither
JAX nor the JAX package, it never runs on the CPU unasked, it refuses
what it has not ported instead of doing something else, its kernel
wrappers never fall back to the plain versions, and ``chip_smoke.py`` fails
without a card or without the repository beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import layout, pruners
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.data.synthetic import make_dataset
from repro_torch.index import ivf, kmeans
from repro_torch.kernels.batched_matmul import batched_distance_quant_cuda
from repro_torch.kernels.pdx_scan import pdx_prune_scan_multi_cuda

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
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[builder]()


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


@pytest.mark.parametrize("spec", [
    dict(executor="jit-masked"),
    dict(executor="cascade-scan"),
    dict(executor="routed_bucket"),
    dict(cascade=("int4", "f32")),
    dict(hbm_slots=4),
])
def test_unported_paths_name_their_roadmap_item(cpu_engine, spec):
    eng, Q = cpu_engine
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        eng.search(Q, SearchSpec(**spec))


def test_unported_engine_calls_name_their_roadmap_item(cpu_engine):
    eng, Q = cpu_engine
    for call in (lambda: eng.insert(Q), lambda: eng.delete([0]), eng.compact,
                 lambda: eng.search(Q, mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
    flat = VectorSearchEngine.build(Q, pruner="linear", capacity=64, device="cpu")
    with pytest.raises(NotImplementedError, match="jit-masked"):
        flat.search(Q[0], SearchSpec(prefer_static=True))
    with pytest.raises(ValueError, match="unknown executor"):
        flat.search(Q[0], SearchSpec(executor="no-such-executor"))


def test_kernel_wrappers_refuse_cpu_tensors_without_fallback():
    before = (pdx_prune_scan_multi_cuda.launches, batched_distance_quant_cuda.launches)
    T = torch.zeros((1, 8, 16))
    f = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pdx_prune_scan_multi_cuda(T, torch.zeros((1, 16), dtype=torch.int32), f,
                                  torch.zeros(1), f, f, dim=8, d_tile=4, eps0=2.1,
                                  quantized=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        batched_distance_quant_cuda(T, torch.zeros((2, 8)), torch.zeros(2), f, f,
                                    metric="l2", quantized=False)
    assert (pdx_prune_scan_multi_cuda.launches,
            batched_distance_quant_cuda.launches) == before


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
