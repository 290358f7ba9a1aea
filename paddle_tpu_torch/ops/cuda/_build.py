"""Build the hand-written CUDA kernels at first use and load them.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface
under ``build/paddle_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags, and loaded with ``ctypes``.  A library
whose hash is already built is loaded as it is.  A failed build raises
with nvcc's stderr.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNELS", "build_all", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_dbias", "fused_ce_fwd", "fused_ce_bwd",
           "fused_adam", "ring_quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME "
                       "or /usr/local/cuda): the CUDA kernels cannot be "
                       "built")


def _sources(name: str) -> list:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    return [src] + sorted(CSRC.glob("*.cuh"))


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, tmp, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp, proc) -> str:
    if proc is None:
        return ""
    out, err = proc.communicate()
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(rc={proc.returncode}):\n{err}{out}")
    os.replace(tmp, target)                # atomic against a racing build
    (BUILD_DIR / f"{name}.log").write_text(err + out)
    return err + out


def build_all(names=KERNELS) -> dict:
    """Build every kernel library at once, one nvcc per source, all
    started together.  Returns {name: compiler log} ('' when cached)."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, tmp, proc = _start(name)
            _finish(name, target, tmp, proc)
            lib = _libs[name] = ctypes.CDLL(str(target))
        return lib
