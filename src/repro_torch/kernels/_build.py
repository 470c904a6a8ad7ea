"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch/<hash of sources and flags>/lib<name>.so`` at the
repository root (``build/`` is git-ignored), with one ``nvcc`` per source,
all started together.  Nothing is built at import: the first kernel launch
(or ``build_all()``) builds, under a file lock so parallel processes on
one machine do not race, and a finished library is reused by every later
process.  Only the repository's own sources and the CUDA toolkit are used.
A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build_all", "library"]

SOURCES = ("pdx_scan", "batched_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the repro_torch CUDA kernels are built from source at first use"
        )
    return found


def build_dir() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((_CSRC / f"{name}.cu").read_bytes())
    return _REPO_ROOT / "build" / "repro_torch" / h.hexdigest()[:16]


def build_all() -> dict:
    """Build every missing library; returns ``{"seconds": wall time,
    "built": [names compiled now], "logs": {name: nvcc output}}``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    logs = {}
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
        if todo:
            nvcc = _nvcc()
            procs = {
                n: subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(out / f"lib{n}.so.tmp"),
                     str(_CSRC / f"{n}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for n in todo
            }
            failed = []
            for n, proc in procs.items():
                logs[n] = proc.communicate()[0]
                (out / f"lib{n}.log").write_text(logs[n])
                if proc.returncode != 0:
                    failed.append(n)
            if failed:
                raise RuntimeError(
                    "nvcc failed for " + ", ".join(failed) + ":\n"
                    + "\n".join(logs[n] for n in failed)
                )
            for n in todo:
                os.replace(out / f"lib{n}.so.tmp", out / f"lib{n}.so")
    return {"seconds": time.perf_counter() - t0, "built": todo, "logs": logs}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
