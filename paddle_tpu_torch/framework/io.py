"""``save`` / ``load`` in the reference's file format (port of
paddle_tpu/framework/io.py).

A file is the 5-byte sentinel ``b"PTPU1"`` and then one pickle
(protocol 4) of the object, in which each tensor is the dict
``{"__ptpu_tensor__": True, "data": ndarray, "name", "stop_gradient",
"is_param"}``; dicts, lists and tuples keep their types and numbers pass
as they are.  So a file written by either package loads in the other,
values bitwise and dtypes kept.

bfloat16 is the one dtype numpy lacks.  The reference pickles it as
``ml_dtypes.bfloat16`` arrays; this module neither imports ``ml_dtypes``
nor needs it: :func:`load` reads that global as a 2-byte view of the
bits and returns bfloat16 tensors, and :func:`save` writes bfloat16
tensors with the same global, so the reference's ``load`` returns them
as bfloat16.

:func:`load` returns tensors on the port's default device (a ``device=``
entry in ``**configs`` overrides it); one saved with ``is_param=True``
comes back as the port's ``Parameter``, with its name.  With
``return_numpy=True`` it returns the numpy arrays (a bfloat16 one as
its 2-byte bits, numpy's ``V2``).  It streams from the file and holds no
second whole-file copy.  A file without the sentinel still loads.
"""
from __future__ import annotations

import io
import os
import pickle
from typing import Any

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.parameter import Parameter

__all__ = ["save", "load", "dumps", "loads"]

_SENTINEL = b"PTPU1"
_BF16_BITS = np.dtype("V2")
# numpy's pickled state of the ml_dtypes bfloat16 dtype
_BF16_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Bfloat16Global:
    """Stands in for ``ml_dtypes.bfloat16`` in a pickle being written."""


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, which lets the bfloat16 dtype be written
    as the reference's global without importing it."""

    def reducer_override(self, obj):
        if isinstance(obj, np.dtype) and obj == _BF16_BITS:
            return (np.dtype, (_Bfloat16Global, False, True), _BF16_STATE)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _Bfloat16Global:
            return super().save_global(obj, name)
        self.save("ml_dtypes")
        self.save("bfloat16")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return "V2"          # np.dtype("V2"): the bits, 2 bytes each
        return super().find_class(module, name)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        is_param = isinstance(obj, Parameter)
        return {"__ptpu_tensor__": True, "data": _array(obj),
                "name": obj.name if is_param else None,
                "stop_gradient": not obj.requires_grad,
                "is_param": is_param}
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


def _tensor(data: np.ndarray, device) -> torch.Tensor:
    data = np.require(data, requirements=["C", "W"])
    if data.dtype.kind == "V" and data.dtype.itemsize == 2:
        return torch.from_numpy(data.view(np.int16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(data).to(device)


def _from_serializable(obj, return_numpy, device):
    if isinstance(obj, dict):
        if obj.get("__ptpu_tensor__"):
            if return_numpy:
                return obj["data"]
            t = _tensor(obj["data"], device)
            if obj.get("is_param"):
                return Parameter(t, trainable=t.is_floating_point(),
                                 name=obj.get("name"))
            if t.is_floating_point() and not obj.get("stop_gradient", True):
                t.requires_grad_()
            return t
        return {k: _from_serializable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy, device)
                         for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """Write ``obj`` (tensors nested in dicts, lists and tuples) to
    ``path``, making its directory."""
    if isinstance(path, str):
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
    payload = _to_serializable(obj)
    with open(path, "wb") as f:
        f.write(_SENTINEL)
        _Pickler(f, protocol=protocol).dump(payload)


def dumps(obj: Any, protocol: int = 4) -> bytes:
    """``save`` into bytes."""
    buf = io.BytesIO()
    buf.write(_SENTINEL)
    _Pickler(buf, protocol=protocol).dump(_to_serializable(obj))
    return buf.getvalue()


def _read(f, return_numpy, configs):
    if f.read(len(_SENTINEL)) != _SENTINEL:
        f.seek(0)
    payload = _Unpickler(f).load()
    device = None if return_numpy else resolve_device(configs.get("device"))
    return _from_serializable(payload, return_numpy, device)


def load(path: str, return_numpy: bool = False, **configs):
    """The object ``save`` wrote (or the reference's ``save``)."""
    with open(path, "rb") as f:
        return _read(f, return_numpy, configs)


def loads(data: bytes, return_numpy: bool = False, **configs):
    """``load`` from bytes."""
    return _read(io.BytesIO(data), return_numpy, configs)
