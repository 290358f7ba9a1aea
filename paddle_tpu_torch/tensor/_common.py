"""What the tensor library's modules share: the reference's dtype rules
(JAX's type promotion with 64-bit types on, paddle_tpu/__init__.py:17),
axis arguments and the device of a call.

JAX's promotion differs from PyTorch's in three places the port must
reproduce: a Python float beside an integer or bool tensor gives float64
(PyTorch: the default float); a 0-d tensor takes part in promotion like
any other (PyTorch lets a 0-d tensor of the same kind lose); and a
Python scalar is rounded to the result's dtype before the operation
(PyTorch computes a bf16 or f16 operation with the scalar in float32).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.framework.dtype import convert_dtype

_SCALARS = (bool, int, float, complex)
_SMALL_INTS = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32)


def is_scalar(v) -> bool:
    """A Python number (JAX's weakly typed values)."""
    return isinstance(v, _SCALARS)


def _strong_dtype(v):
    if isinstance(v, torch.Tensor):
        return v.dtype
    if isinstance(v, (np.ndarray, np.generic)):
        return convert_dtype(v.dtype)
    return None


def _kind(dt) -> int:
    if dt == torch.bool:
        return 0
    if dt.is_complex:
        return 3
    if dt.is_floating_point:
        return 2
    return 1


def result_type(*args) -> torch.dtype:
    """The dtype JAX (64-bit types on) gives an operation on ``args``:
    tensors and numpy values by PyTorch's table of pairs (it agrees with
    JAX's for the dtypes PyTorch has), then each Python number as a weak
    type."""
    dt = None
    for a in args:
        s = _strong_dtype(a)
        if s is not None:
            dt = s if dt is None else torch.promote_types(dt, s)
    weak = [a for a in args if is_scalar(a)]
    if dt is None:
        kind = builtins.max((_kind_of_scalar(w) for w in weak), default=0)
        return (torch.bool, torch.int64, torch.float64,
                torch.complex128)[kind]
    for w in weak:
        k = _kind_of_scalar(w)
        if k <= _kind(dt):
            continue
        if k == 1:
            dt = torch.int64
        elif k == 2:
            dt = torch.float64
        elif dt in (torch.float16, torch.bfloat16, torch.float32):
            dt = torch.complex64
        else:
            dt = torch.complex128
    return dt


def _kind_of_scalar(v) -> int:
    if isinstance(v, bool):
        return 0
    if isinstance(v, int):
        return 1
    if isinstance(v, float):
        return 2
    return 3


def inexact(dt: torch.dtype) -> torch.dtype:
    """JAX's ``to_inexact_dtype``: an integer or bool dtype of up to 32
    bits becomes float32, int64 float64; floats stay."""
    if dt.is_floating_point or dt.is_complex:
        return dt
    return torch.float32 if dt in _SMALL_INTS else torch.float64


def sum_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype of ``jnp.sum`` / ``jnp.prod``: bool and signed integers
    accumulate in int64; floats stay."""
    if dt.is_floating_point or dt.is_complex:
        return dt
    return torch.int64


def device_of(*args, default=None):
    """The device of the first tensor among ``args``."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return default


def cast(v, dt: torch.dtype, device=None):
    """A tensor of dtype ``dt``: tensors are cast (on their device), numpy
    values moved to ``device``, Python numbers made 0-d on ``device`` --
    rounded to ``dt`` before the operation, as JAX converts a weak
    value."""
    if isinstance(v, torch.Tensor):
        return v if v.dtype == dt else v.to(dt)
    if isinstance(v, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(v), device=device).to(dt)
    return torch.full((), v, dtype=dt, device=device)


def promote(*args, inexact_result=False, device=None):
    """(dtype, device, operands): ``args`` cast to their common dtype
    (:func:`inexact` of it if ``inexact_result``); Python numbers become
    0-d tensors on the first tensor's device (``device`` if none)."""
    dt = result_type(*args)
    if inexact_result:
        dt = inexact(dt)
    dev = device_of(*args, default=device)
    return dt, dev, [cast(a, dt, dev) for a in args]


def reduce_dims(axis, ndim: int):
    """The non-negative axes of ``axis`` (an int, a list or a tuple; a
    tensor axis is read to the host) as a tuple, every axis for None."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if not isinstance(axis, (list, tuple)):
        axis = (axis,)
    return tuple(int(a) % builtins.max(ndim, 1) for a in axis)


def moved_flat(x: torch.Tensor, dims):
    """x with the axes ``dims`` moved last and flattened into one:
    (x', keep shape)."""
    dims = tuple(dims)
    rest = [d for d in range(x.ndim) if d not in dims]
    x = x.permute(*rest, *dims)
    keep = x.shape[:len(rest)]
    return x.reshape(*keep, -1), keep


def keepdim_shape(shape, dims):
    """``shape`` with the axes ``dims`` set to 1."""
    return tuple(1 if i in dims else s for i, s in enumerate(shape))
