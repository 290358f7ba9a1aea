"""The native datafeed engine, loaded with ctypes (port of paddle_tpu/ops/
native/__init__.py).

``csrc/datafeed.cpp`` is built at first use by the system ``g++`` into
``build/paddle_tpu_torch/`` at the root of the checkout (the kernels'
directory, ``ops/cuda/_build.py``), named by a hash of the source and
flags, so a library already built is loaded as it is and nothing is
written beside the sources.  A failed build raises with g++'s stderr.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.ops.cuda._build import BUILD_DIR, CSRC

__all__ = ["MultiSlotDataFeed", "native_available", "lib_path"]

SRC = CSRC / "datafeed.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_err: Optional[str] = None


def lib_path() -> str:
    """Where the library of this source and these flags is (or will be)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return str(BUILD_DIR / f"datafeed-{h.hexdigest()[:16]}.so")


def _build(target: str) -> Optional[str]:
    """g++ into ``target``; the error text, or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e}"
    if r.returncode != 0:
        return f"g++ failed: {r.stderr[-2000:]}"
    os.replace(tmp, target)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_err
    with _lock:
        if _lib is not None:
            return _lib
        if _build_err is not None:
            return None
        target = lib_path()
        if not os.path.exists(target):
            _build_err = _build(target)
            if _build_err is not None:
                return None
        lib = ctypes.CDLL(target)
        lib.df_create.restype = ctypes.c_void_p
        lib.df_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
        lib.df_add_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.df_start.argtypes = [ctypes.c_void_p]
        lib.df_next.argtypes = [ctypes.c_void_p]
        lib.df_next.restype = ctypes.c_int
        lib.df_dense.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_float)]
        lib.df_sparse_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.df_sparse_total.restype = ctypes.c_longlong
        lib.df_sparse.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.POINTER(ctypes.c_longlong)]
        lib.df_error.argtypes = [ctypes.c_void_p]
        lib.df_error.restype = ctypes.c_char_p
        lib.df_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class MultiSlotDataFeed:
    """A multi-slot text feed parsed and batched on C++ threads.

    ``slots``: (name, kind, dim) each, kind 'f' a dense float32 row of
    ``dim`` values, 'u' a variable-length int64 id list.  Iterating yields
    dicts: a dense slot as float32 (B, dim), a sparse one as (ids (total,)
    int64, lengths (B,) int64).  The feed is single-pass: build one an
    epoch.  With ``nthreads`` > 1 the batches' order follows the reader
    threads.  A record that does not parse or a file that does not open
    raises ``RuntimeError`` at the end of the pass."""

    def __init__(self, slots: Sequence[Tuple[str, str, int]],
                 batch_size: int, files: Sequence[str] = (),
                 nthreads: int = 4, capacity: int = 16):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native datafeed unavailable: {_build_err}")
        self._lib = lib
        self.slots = [(n, k, int(d)) for n, k, d in slots]
        self.batch_size = batch_size
        schema = ",".join(f"{n}:{k}:{d}" for n, k, d in self.slots)
        self._h = lib.df_create(schema.encode(), batch_size, nthreads,
                                capacity)
        self._files: List[str] = []
        self._started = False
        for f in files:
            self.add_file(f)

    def add_file(self, path: str):
        if self._started:
            raise RuntimeError("add_file after start")
        self._files.append(path)
        self._lib.df_add_file(self._h, os.fspath(path).encode())

    def _check_error(self):
        err = self._lib.df_error(self._h)
        if err:
            raise RuntimeError(err.decode())

    def __iter__(self):
        if self._h is None:
            raise RuntimeError("feed already destroyed")
        if self._started:
            raise RuntimeError("MultiSlotDataFeed is single-pass; build a "
                               "new one per epoch (reference DataFeed "
                               "Start() semantics)")
        self._started = True
        self._lib.df_start(self._h)
        lib, h = self._lib, self._h
        while True:
            rows = lib.df_next(h)
            if rows == 0:
                self._check_error()
                return
            out: Dict[str, object] = {}
            for s, (name, kind, dim) in enumerate(self.slots):
                if kind == "f":
                    arr = np.empty((rows, dim), np.float32)
                    lib.df_dense(h, s, arr.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_float)))
                    out[name] = arr
                else:
                    total = lib.df_sparse_total(h, s)
                    ids = np.empty((total,), np.int64)
                    lens = np.empty((rows,), np.int64)
                    lib.df_sparse(
                        h, s,
                        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                        lens.ctypes.data_as(ctypes.POINTER(
                            ctypes.c_longlong)))
                    out[name] = (ids, lens)
            yield out

    def close(self):
        if self._h is not None:
            self._lib.df_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:       # noqa: BLE001
            pass
