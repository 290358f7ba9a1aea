"""Tensor creation (port of paddle_tpu/tensor/creation.py).

Every function that makes a tensor from Python values takes the port's
``device=`` keyword and resolves it with
:func:`paddle_tpu_torch.device.resolve_device`: the card unless the
caller asks for ``"cpu"``, and an error where CUDA is asked for and
absent.  The ``*_like`` functions make their tensor on ``x``'s device
unless ``device`` is given.

The reference's dtype rules hold: a Python float, or a list of them,
becomes the default dtype (float32) and a numpy array keeps its dtype
(``core.py:351-358``); ``full`` with a bool fill is bool, with an int
fill int64 (``:59-71``); ``arange`` is int64 when start, end and step
are all ints (``:94-104``); ``empty`` / ``empty_like`` are zeros
(``:73``, ``:90``), never uninitialised memory; ``linspace`` and
``logspace`` use jnp's formula in the output's dtype.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.dtype import convert_dtype, default_dtype
from paddle_tpu_torch.tensor._common import inexact

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "meshgrid", "diag", "diagflat", "tril", "triu", "assign", "clone",
    "numel", "tolist", "create_parameter", "create_tensor", "complex",
    "as_tensor",
]


def _dtype(dtype, default=None) -> torch.dtype:
    if dtype is None:
        return default_dtype() if default is None else default
    return convert_dtype(dtype)


def _device(device, place=None):
    if device is None and place is not None:
        device = str(place).replace("gpu", "cuda")
    return resolve_device(device)


def _numpy(data):
    """numpy of a (nested) list that may hold tensors."""
    if isinstance(data, (list, tuple)):
        return np.asarray([_numpy(d) for d in data])
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return data


def _from_numpy(arr: np.ndarray, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.require(arr, requirements="C"))
    return t.to(device=device, dtype=dtype or t.dtype)


def to_tensor(data, dtype=None, place=None, stop_gradient=True,
              device=None) -> torch.Tensor:
    """A new tensor of ``data`` (a tensor, numpy array, Python number or
    nested list) on ``device`` (``place`` maps onto it, ``"gpu"`` read as
    ``"cuda"``).  Python floats become the default dtype; numpy arrays
    keep theirs.  ``stop_gradient=False`` makes a float tensor a leaf
    that requires grad."""
    dev = _device(device, place)
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=dt or data.dtype,
                               copy=True)
    else:
        was_ndarray = isinstance(data, np.ndarray)
        arr = np.asarray(_numpy(data))
        if dt is None and arr.dtype == np.float64 and not was_ndarray:
            dt = default_dtype()
        out = _from_numpy(arr, dt, dev)
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out.requires_grad_()
    return out


as_tensor = to_tensor


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s) for s in shape]


def zeros(shape, dtype=None, name=None, device=None) -> torch.Tensor:
    return torch.zeros(_shape(shape), dtype=_dtype(dtype),
                       device=_device(device))


def ones(shape, dtype=None, name=None, device=None) -> torch.Tensor:
    return torch.ones(_shape(shape), dtype=_dtype(dtype),
                      device=_device(device))


def _fill_dtype(fill_value):
    if isinstance(fill_value, bool):
        return torch.bool
    if isinstance(fill_value, int):
        return torch.int64
    return default_dtype()


def full(shape, fill_value, dtype=None, name=None,
         device=None) -> torch.Tensor:
    """A tensor of ``fill_value``: bool for a bool fill, int64 for an int
    fill, else the default dtype, unless ``dtype`` is given (a tensor
    fill is read to the host, as the reference reads it)."""
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    dt = _fill_dtype(fill_value) if dtype is None else convert_dtype(dtype)
    return torch.full(_shape(shape), fill_value, dtype=dt,
                      device=_device(device))


def empty(shape, dtype=None, name=None, device=None) -> torch.Tensor:
    """Zeros, as the reference's ``empty`` is."""
    return zeros(shape, dtype=dtype, device=device)


def _like_device(x, device):
    return x.device if device is None else resolve_device(device)


def zeros_like(x, dtype=None, name=None, device=None) -> torch.Tensor:
    return torch.zeros(x.shape, dtype=_dtype(dtype, x.dtype),
                       device=_like_device(x, device))


def ones_like(x, dtype=None, name=None, device=None) -> torch.Tensor:
    return torch.ones(x.shape, dtype=_dtype(dtype, x.dtype),
                      device=_like_device(x, device))


def full_like(x, fill_value, dtype=None, name=None,
              device=None) -> torch.Tensor:
    return torch.full(x.shape, fill_value, dtype=_dtype(dtype, x.dtype),
                      device=_like_device(x, device))


def empty_like(x, dtype=None, name=None, device=None) -> torch.Tensor:
    """Zeros, as the reference's ``empty_like`` is."""
    return zeros_like(x, dtype=dtype, device=device)


def _value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


_NP_DTYPES = {torch.float16: np.float16, torch.float32: np.float32,
              torch.float64: np.float64, torch.int8: np.int8,
              torch.int16: np.int16, torch.int32: np.int32,
              torch.int64: np.int64, torch.uint8: np.uint8,
              torch.bool: np.bool_}


def arange(start=0, end=None, step=1, dtype=None, name=None,
           device=None) -> torch.Tensor:
    """numpy's ``arange`` in the output dtype, as jnp computes it for
    concrete arguments (bfloat16 in float32, then rounded); int64 when
    start, end and step are all ints, else the default dtype."""
    start, end, step = _value(start), _value(end), _value(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = builtins.all(isinstance(v, (int, np.integer))
                            for v in (start, end, step))
        dt = torch.int64 if ints else default_dtype()
    else:
        dt = convert_dtype(dtype)
    arr = np.arange(start, end, step, dtype=_NP_DTYPES.get(dt, np.float32))
    return _from_numpy(arr, dt, _device(device))


def _linspace(start, stop, num, dt, device):
    """jnp.linspace (endpoint included) in the computation dtype
    :func:`inexact` of ``dt``: ``start * (1 - t) + stop * t`` with
    ``t = i / (num - 1)``, the last value ``stop`` itself; floored for an
    integer ``dt``.  ``start`` / ``stop`` are Python numbers (taken in
    float64, as JAX takes them) or 0-d tensors."""
    cdt = inexact(dt)
    start, stop = (v.to(device, cdt) if isinstance(v, torch.Tensor) else
                   torch.full((), v, dtype=torch.float64, device=device)
                   .to(cdt) for v in (start, stop))
    if num > 1:
        div = num - 1
        iota = torch.arange(div, device=device, dtype=cdt)
        recip = 1 / torch.full((), div, dtype=cdt, device=device)
        head = start * (1 - iota * recip)
        if cdt == torch.float32:
            # the product iota * (stop / div) fused into the sum, exact
            # in float64 (24 + 24 bits), one rounding back to float32
            tail = iota.double() * (stop * recip).double()
            head = (head.double() + tail).float()
        else:
            head = head + iota * (stop * recip)
        out = torch.cat([head, stop.reshape(1)])
    elif num == 1:
        out = start.reshape(1)
    else:
        out = torch.zeros(0, dtype=cdt, device=device)
    if not (dt.is_floating_point or dt.is_complex):
        out = torch.floor(out)
    return out.to(dt)


def linspace(start, stop, num, dtype=None, name=None,
             device=None) -> torch.Tensor:
    dt = _dtype(dtype)
    return _linspace(_value(start), _value(stop), int(_value(num)), dt,
                     _device(device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             device=None) -> torch.Tensor:
    """``base ** linspace(start, stop, num)`` in the output dtype."""
    dt = _dtype(dtype)
    cdt = inexact(dt)
    lin = _linspace(_value(start), _value(stop), int(_value(num)), cdt,
                    _device(device))
    return torch.pow(base, lin).to(dt)


def eye(num_rows, num_columns=None, dtype=None, name=None,
        device=None) -> torch.Tensor:
    return torch.eye(int(num_rows), int(num_rows if num_columns is None
                                        else num_columns),
                     dtype=_dtype(dtype), device=_device(device))


def meshgrid(*args, **kwargs):
    """Matrix (``"ij"``) indexing, as the reference's."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*args, indexing="ij"))


def diag(x, offset=0, padding_value=0, name=None) -> torch.Tensor:
    """A 1-D x: the square matrix with x on diagonal ``offset`` and
    ``padding_value`` elsewhere; a 2-D x: its diagonal ``offset``."""
    if x.ndim == 1 and padding_value != 0:
        n = x.shape[0] + builtins.abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        return base.diagonal_scatter(x, offset)
    return torch.diag(x, offset)


def diagflat(x, offset=0, name=None) -> torch.Tensor:
    return torch.diagflat(x, offset)


def tril(x, diagonal=0, name=None) -> torch.Tensor:
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None) -> torch.Tensor:
    return torch.triu(x, diagonal)


def assign(x, output=None, device=None) -> torch.Tensor:
    """A copy of ``x`` (a tensor, or numpy / Python values made a tensor
    with their numpy dtype), differentiable; with ``output``, the value
    is copied into ``output`` in place, outside autograd's tape, and
    ``output`` returned."""
    if not isinstance(x, torch.Tensor):
        x = _from_numpy(np.asarray(x), None,
                        _device(device) if output is None
                        else output.device)
    if output is None:
        return x.clone()
    with torch.no_grad():
        output.copy_(x)
    return output


def clone(x, name=None) -> torch.Tensor:
    return x.clone()


def numel(x, name=None) -> torch.Tensor:
    """The number of elements, a 0-d int64 tensor on x's device."""
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def tolist(x):
    return x.tolist()


def create_tensor(dtype="float32", name=None, persistable=False,
                  device=None) -> torch.Tensor:
    """A 0-d zero of ``dtype``."""
    return torch.zeros((), dtype=convert_dtype(dtype),
                       device=_device(device))


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None, device=None):
    """A parameter from the port's factory (``nn.initializer
    ._create_param``): zeros for a bias, Xavier-uniform otherwise, unless
    ``attr`` or ``default_initializer`` says."""
    from paddle_tpu_torch.nn.initializer import _create_param
    return _create_param(shape, dtype, attr=attr, is_bias=is_bias,
                         default_initializer=default_initializer, name=name,
                         device=device)


def complex(real, imag, name=None) -> torch.Tensor:
    """real + i imag: complex64 from float32 parts, complex128 from
    float64."""
    return torch.complex(real, imag)
