"""Weight initializers and the parameter factory (port of
paddle_tpu/nn/initializer/__init__.py).

An initializer is a callable ``(shape, dtype, device, generator) ->
tensor``.  Fans, gains, bounds and standard deviations are computed as
the reference computes them (``calculate_gain`` :27, ``_fan_in_out`` :39,
the classes :59-208); the random draws come from ``torch``, on the device
of the parameter they fill, from ``generator`` (that device's default
generator when None), so only the distributions match the reference's
``jax.random`` draws.  ``Constant``, ``Assign`` and ``Dirac`` are exact.

:func:`_create_param` (reference ``:210-236``) makes a parameter from a
``ParamAttr``: its initializer, ``trainable`` (as ``requires_grad``),
``optimize_attr = {"learning_rate": lr}``, ``regularizer``, ``is_bias``
and ``name``, which the optimizers read.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.dtype import convert_dtype
from paddle_tpu_torch.framework.parameter import Parameter

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Dirac", "Orthogonal", "calculate_gain",
]


def _dtype(dtype) -> torch.dtype:
    if dtype is None:
        raise ValueError("unknown dtype None")
    return convert_dtype(dtype)


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "selu": 3.0 / 4.0}
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity in gains:
        return gains[nonlinearity]
    raise ValueError(f"unknown nonlinearity {nonlinearity}")


def _fan_in_out(shape: Sequence[int]):
    """The reference's fans: (in, out) of a 2-D weight stored (in, out);
    for a convolution's (out, in, *kernel) the receptive field times in
    and out; a vector's length for both."""
    shape = list(shape)
    if len(shape) < 2:
        fan_in = fan_out = shape[0] if shape else 1
    elif len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    else:
        receptive = int(np.prod(shape[2:]))
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    return fan_in, fan_out


class Initializer:
    def __call__(self, shape, dtype="float32", device=None, generator=None):
        raise NotImplementedError

    @staticmethod
    def _empty(shape, dtype, device):
        return torch.empty(tuple(int(s) for s in shape), dtype=_dtype(dtype),
                           device=resolve_device(device))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        return self._empty(shape, dtype, device).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        return self._empty(shape, dtype, device).normal_(
            self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """Normal(mean, std) cut at two standard deviations, as the
    reference's ``truncated_normal(-2, 2)``."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        out = self._empty(shape, dtype, device)
        return nn.init.trunc_normal_(out, self.mean, self.std,
                                     self.mean - 2.0 * self.std,
                                     self.mean + 2.0 * self.std,
                                     generator=generator)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        return self._empty(shape, dtype, device).uniform_(
            self.low, self.high, generator=generator)


class _Fans(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self._fan_in, self._fan_out = fan_in, fan_out

    def _fans(self, shape):
        fi, fo = _fan_in_out(shape)
        return (self._fan_in if self._fan_in is not None else fi,
                self._fan_out if self._fan_out is not None else fo)


class XavierNormal(_Fans):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        super().__init__(fan_in, fan_out)
        self.gain = gain

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        fi, fo = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return self._empty(shape, dtype, device).normal_(
            0.0, std, generator=generator)


class XavierUniform(_Fans):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        super().__init__(fan_in, fan_out)
        self.gain = gain

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return self._empty(shape, dtype, device).uniform_(
            -limit, limit, generator=generator)


class _Kaiming(_Fans):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        super().__init__(fan_in, None)
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain_fan(self, shape):
        return (calculate_gain(self.nonlinearity, self.negative_slope),
                self._fans(shape)[0])


class KaimingNormal(_Kaiming):
    def __call__(self, shape, dtype="float32", device=None, generator=None):
        gain, fi = self._gain_fan(shape)
        return self._empty(shape, dtype, device).normal_(
            0.0, gain / math.sqrt(fi), generator=generator)


class KaimingUniform(_Kaiming):
    def __call__(self, shape, dtype="float32", device=None, generator=None):
        gain, fi = self._gain_fan(shape)
        limit = gain * math.sqrt(3.0 / fi)
        return self._empty(shape, dtype, device).uniform_(
            -limit, limit, generator=generator)


class Assign(Initializer):
    """The given values (an array, a list or a tensor), reshaped."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        v = self.value
        v = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        return v.to(device=resolve_device(device),
                    dtype=_dtype(dtype)).reshape(tuple(shape)).clone()


class Dirac(Initializer):
    """An identity convolution: ones at each group's (d, d, centre)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        arr = np.zeros(shape, dtype=np.float32)
        out_per_group = shape[0] // self.groups
        min_dim = min(out_per_group, shape[1])
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for d in range(min_dim):
                arr[(g * out_per_group + d, d) + tuple(centers)] = 1.0
        return torch.from_numpy(arr).to(device=resolve_device(device),
                                        dtype=_dtype(dtype))


class Orthogonal(Initializer):
    """Q of the QR of a normal (max(r, c), min(r, c)) draw, signs fixed by
    R's diagonal, transposed when rows < cols, times ``gain``."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        dev = resolve_device(device)
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = torch.empty(max(rows, cols), min(rows, cols),
                           device=dev).normal_(generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(
            _dtype(dtype)).contiguous()


# legacy-name aliases (fluid.initializer)
ConstantInitializer = Constant
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
UniformInitializer = Uniform
XavierInitializer = XavierNormal
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign

def _create_param(shape, dtype="float32", attr=None, is_bias=False,
                  default_initializer=None, name=None, device=None,
                  generator=None) -> Parameter:
    """A parameter of ``shape`` on ``device`` (the card unless "cpu")
    from ``attr`` (None or a ``ParamAttr``; False is the caller's to
    handle).  Without an initializer: zeros for a bias, Xavier-uniform
    otherwise.  The parameter carries ``trainable``, ``optimize_attr``,
    ``regularizer``, ``is_bias`` and ``name`` (a generated one unless the
    attr or ``name`` gives it)."""
    from paddle_tpu_torch.nn.layer.common import ParamAttr
    init, trainable, regularizer, lr, pname = (default_initializer, True,
                                               None, 1.0, name)
    if isinstance(attr, ParamAttr):
        init = attr.initializer or init
        trainable = attr.trainable
        regularizer = attr.regularizer
        lr = attr.learning_rate
        pname = attr.name or pname
    elif attr is False:
        raise ValueError("_create_param called with attr=False")
    elif attr is not None:
        raise TypeError(f"_create_param: attr {attr!r} is not a ParamAttr")
    if init is None:
        init = Constant(0.0) if is_bias else XavierUniform()
    data = init([int(s) for s in shape], dtype or "float32", device,
                generator)
    return Parameter(data, trainable=trainable, name=pname,
                     regularizer=regularizer, learning_rate=lr,
                     is_bias=is_bias)
