"""Activations (port of paddle_tpu/nn/functional/activation.py).

Each computes the reference's formula with its defaults (``hardsigmoid``'s
slope 0.1666667, ``selu``'s scale and alpha, ``softplus``'s threshold 20,
...), and each is the counterpart of one reference op of the same name
for ``amp.auto_cast``.  The random ones, ``rrelu`` in training mode and
``gumbel_softmax``, draw from ``generator`` (the default generator of the
input's device when None): only the distribution matches the
reference's ``jax.random`` bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import amp_op

__all__ = [
    "relu", "relu_", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
    "hardsigmoid", "hardswish", "hardtanh", "hardshrink", "softshrink",
    "tanhshrink", "leaky_relu", "prelu", "rrelu", "log_sigmoid", "maxout",
    "silu", "swish", "mish", "softmax", "log_softmax", "softplus", "softsign",
    "tanh", "tanh_", "thresholded_relu", "glu", "gumbel_softmax",
]


@amp_op("relu")
def relu(x, name=None):
    return F.relu(x)


def relu_(x, name=None):
    """In place, outside autograd's record as the reference's."""
    with torch.no_grad():
        return x.relu_()


def _bound(x, v):
    """``v`` as a 0-d CPU tensor of x's dtype: a scalar operand, so that no
    copy to the card is made."""
    return torch.tensor(v, dtype=x.dtype)


def _clip(x, lo, hi):
    """``jnp.clip``: a maximum, then a minimum, whose gradient at a bound
    splits in halves as JAX's (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, _bound(x, lo)), _bound(x, hi))


@amp_op("relu6")
def relu6(x, name=None):
    return _clip(x, 0.0, 6.0)


@amp_op("elu")
def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(torch.where(
        x > 0, torch.zeros_like(x), x)))


@amp_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@amp_op("celu")
def celu(x, alpha=1.0, name=None):
    zero = _bound(x, 0.0)
    return torch.maximum(x, zero) + alpha * torch.expm1(
        torch.minimum(x, zero) / alpha)


@amp_op("gelu")
def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, tanh-approximated with
    ``approximate=True``, as the reference's ``jax.nn.gelu``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


@amp_op("sigmoid")
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@amp_op("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return _clip(slope * x + offset, 0.0, 1.0)


@amp_op("hardswish")
def hardswish(x, name=None):
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


@amp_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _clip(x, min, max)


@amp_op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, 0.0)


@amp_op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


@amp_op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@amp_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


@amp_op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight * x``: one weight, or one per
    channel (axis 1 in NCHW, the last axis otherwise)."""
    if weight.numel() == 1:
        w = weight.reshape(())
    elif data_format == "NCHW" and x.dim() > 1:
        w = weight.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:
        w = weight
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None,
          generator=None):
    """Training: each negative entry times a slope drawn uniform in
    [lower, upper); else ``leaky_relu`` at their mean."""
    if training:
        return _rrelu(x, lower, upper, generator)
    return leaky_relu(x, (lower + upper) / 2.0)


@amp_op("rrelu")
def _rrelu(x, lower, upper, generator):
    slope = torch.empty_like(x).uniform_(lower, upper, generator=generator)
    return torch.where(x >= 0, x, slope * x)


@amp_op("log_sigmoid")
def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


@amp_op("maxout")
def maxout(x, groups, axis=1, name=None):
    """The largest of each run of ``groups`` channels along ``axis``."""
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + tuple(
        x.shape[ax + 1:])
    return torch.amax(x.reshape(shape), dim=ax + 1)


@amp_op("silu")
def silu(x, name=None):
    return F.silu(x)


@amp_op("swish")
def swish(x, name=None):
    return F.silu(x)


def _softplus(x):
    """``log(1 + exp(x))`` with no threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros_like(x))


@amp_op("mish")
def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def _as_dtype(dtype):
    """A torch dtype from a torch dtype or a name ("float32", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype).lower().replace("paddle.", ""), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


@amp_op("softmax")
def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax along ``axis``, of x cast to ``dtype`` first when given
    (reference ``:143``)."""
    if dtype is not None:
        x = x.to(_as_dtype(dtype))
    return torch.softmax(x, dim=axis)


@amp_op("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    """Log-softmax along ``axis``, of x cast to ``dtype`` first when given
    (reference ``:155``)."""
    if dtype is not None:
        x = x.to(_as_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


@amp_op("softplus")
def softplus(x, beta=1.0, threshold=20.0, name=None):
    return torch.where(beta * x > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(beta * x)))


@amp_op("softsign")
def softsign(x, name=None):
    return x / (1 + torch.abs(x))


@amp_op("tanh")
def tanh(x, name=None):
    return torch.tanh(x)


def tanh_(x, name=None):
    """In place, outside autograd's record as the reference's."""
    with torch.no_grad():
        return x.tanh_()


@amp_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, 0.0)


@amp_op("glu")
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@amp_op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """Softmax of (x + Gumbel noise) / temperature along ``axis``; with
    ``hard`` the one-hot of its argmax in value and the soft gradient
    (straight through)."""
    u = torch.empty_like(x).uniform_(torch.finfo(x.dtype).tiny, 1.0,
                                     generator=generator)
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        y_hard = torch.zeros_like(y).scatter_(
            axis, torch.argmax(y, dim=axis, keepdim=True), 1.0)
        y = y_hard + (y - y.detach())
    return y
