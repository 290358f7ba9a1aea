"""The port's one dtype map (port of paddle_tpu/core.py:62-112).

:func:`convert_dtype` turns any dtype spec the reference takes (a name
with the reference's aliases, ``"paddle.float32"``, a numpy dtype or
type, a Python type) or a ``torch.dtype`` into a ``torch.dtype``.
:func:`get_default_dtype` / :func:`set_default_dtype` hold the dtype that
Python floats become (float32 unless set), as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "get_default_dtype", "set_default_dtype",
           "default_dtype"]

# the reference's aliases (core.py:62-82)
_ALIASES = {
    "float16": torch.float16, "fp16": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64,
    "double": torch.float64, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "int": torch.int32, "bool": torch.bool, "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_default = torch.float32


def convert_dtype(dtype):
    """A ``torch.dtype`` for ``dtype`` (None stays None); raises
    ``ValueError`` for a spec it cannot read."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("torch.", "")
        if key in _ALIASES:
            return _ALIASES[key]
        found = getattr(torch, key, None)
        if isinstance(found, torch.dtype):
            return found
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = None
    found = getattr(torch, name, None) if name else None
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


def set_default_dtype(d) -> None:
    """The dtype Python floats become: one of float16, bfloat16, float32,
    float64 (reference core.py:89-97)."""
    global _default
    d = convert_dtype(d)
    if d not in _FLOATS:
        raise TypeError("set_default_dtype only supports float16/bfloat16/"
                        f"float32/float64, got {d}")
    _default = d


def get_default_dtype() -> str:
    """The default dtype's name, ``"float32"`` unless set."""
    return str(_default).replace("torch.", "")


def default_dtype() -> torch.dtype:
    """The default dtype as a ``torch.dtype``."""
    return _default
