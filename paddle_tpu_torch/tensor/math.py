"""Elementwise, reduction and cumulative math (port of
paddle_tpu/tensor/math.py).

Each function reproduces the reference's dtypes, values and gradients:

- promotion is JAX's with 64-bit types on (``_common``): int32 plus the
  Python float 1.5 is float64, ``reciprocal`` of an integer tensor is
  float64, int32 / int32 ``divide`` is float32; the functions of floats
  (``exp``, ``sqrt``, ``mean``, ...) take an integer tensor of up to 32
  bits to float32 and int64 to float64; ``sum`` / ``prod`` / ``trace``
  of bool or a small integer are int64, ``cumsum`` / ``cumprod`` keep an
  integer dtype;
- ``hypot`` is ``sqrt(a*a + b*b)`` (``:108``): it overflows where
  ``torch.hypot`` does not;
- ``digamma`` is NaN at 0 and its gradient infinite at the non-positive
  integers, as jax.scipy's; ``lgamma``'s gradient is that ``digamma``;
  ``sign`` of NaN is NaN;
- ``max`` / ``min`` / ``amax`` / ``amin`` split a tied gradient evenly
  (``torch.amax``); ``maximum`` / ``minimum`` and ``clip`` halve it at a
  tie or a bound (``torch.maximum`` / ``torch.minimum``, never
  ``torch.clamp``); ``fmax`` / ``fmin`` give it to y at a tie;
- ``cummax`` / ``cummin`` indices point at the last tied position;
- ``scale`` keeps an integer input's dtype, ``cross`` defaults to axis
  -1, ``dot`` sums over the last axis, ``increment`` adds in place
  outside the tape, and ``accuracy`` ranks with the port's ``topk``
  (among ties the lower index first).
"""
from __future__ import annotations

import builtins

import torch

from paddle_tpu_torch.framework.dtype import convert_dtype
from paddle_tpu_torch.tensor._common import (cast, inexact, is_scalar,
                                             keepdim_shape, moved_flat,
                                             promote, reduce_dims,
                                             result_type, sum_dtype)

__all__ = []


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _float_unary(tfn, name):
    def op(x, name=None):
        return tfn(x.to(inexact(x.dtype)))
    op.__name__ = name
    op.__doc__ = f"``{tfn.__name__}`` of x; an integer x is taken to " \
                 "float32 (int64 to float64) first."
    __all__.append(name)
    return op


def _same_unary(tfn, name, int_fn=None):
    def op(x, name=None):
        if x.is_floating_point() or x.is_complex():
            return tfn(x)
        return (int_fn or tfn)(x)
    op.__name__ = name
    op.__doc__ = f"``{tfn.__name__}`` of x, in x's dtype."
    __all__.append(name)
    return op


def _nan_sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _trigamma(x):
    """jax.scipy's polygamma(1, x): infinite at the non-positive
    integers and at -inf, NaN at +inf."""
    out = torch.polygamma(1, x)
    pole = (x <= 0) & (x == torch.floor(x))
    out = torch.where(pole | (x == -float("inf")),
                      torch.full_like(out, float("inf")), out)
    return torch.where(x == float("inf"), torch.full_like(out, float("nan")),
                       out)


def _digamma_values(x):
    return torch.where(x == 0, torch.full_like(x, float("nan")),
                       torch.digamma(x))


class _Digamma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _digamma_values(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _trigamma(x)


class _Lgamma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.lgamma(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _digamma_values(x)


def _angle(x):
    """jnp.angle: atan2(imag, real); an integer or 0-d float input is
    taken to float64 first."""
    if x.is_complex():
        return torch.angle(x)
    if not x.is_floating_point() or x.ndim == 0:
        x = x.to(torch.float64)
    return torch.atan2(torch.zeros_like(x), x)


def _keep(x):
    return x.clone()


# --- unary ------------------------------------------------------------------
exp = _float_unary(torch.exp, "exp")
expm1 = _float_unary(torch.expm1, "expm1")
log = _float_unary(torch.log, "log")
log2 = _float_unary(torch.log2, "log2")
log10 = _float_unary(torch.log10, "log10")
log1p = _float_unary(torch.log1p, "log1p")
sqrt = _float_unary(torch.sqrt, "sqrt")
rsqrt = _float_unary(torch.rsqrt, "rsqrt")
square = _same_unary(torch.square, "square")
abs = _same_unary(torch.abs, "abs",
                  lambda x: x.clone() if x.dtype == torch.bool
                  else torch.abs(x))
sign = _same_unary(_nan_sign, "sign", torch.sign)
ceil = _same_unary(torch.ceil, "ceil", _keep)
floor = _same_unary(torch.floor, "floor", _keep)
round = _same_unary(torch.round, "round", _keep)
trunc = _same_unary(torch.trunc, "trunc", _keep)
frac = _same_unary(lambda x: x - torch.trunc(x), "frac", torch.zeros_like)
sin = _float_unary(torch.sin, "sin")
cos = _float_unary(torch.cos, "cos")
tan = _float_unary(torch.tan, "tan")
asin = _float_unary(torch.asin, "asin")
acos = _float_unary(torch.acos, "acos")
atan = _float_unary(torch.atan, "atan")
sinh = _float_unary(torch.sinh, "sinh")
cosh = _float_unary(torch.cosh, "cosh")
tanh = _float_unary(torch.tanh, "tanh")
asinh = _float_unary(torch.asinh, "asinh")
acosh = _float_unary(torch.acosh, "acosh")
atanh = _float_unary(torch.atanh, "atanh")
erf = _float_unary(torch.erf, "erf")
erfinv = _float_unary(torch.erfinv, "erfinv")
neg = _same_unary(torch.neg, "neg")
digamma = _float_unary(_Digamma.apply, "digamma")
lgamma = _float_unary(_Lgamma.apply, "lgamma")
sigmoid = _float_unary(torch.sigmoid, "sigmoid")
conj = _same_unary(torch.conj, "conj", _keep)
angle = _same_unary(_angle, "angle")
deg2rad = _float_unary(torch.deg2rad, "deg2rad")
rad2deg = _float_unary(torch.rad2deg, "rad2deg")


@_export
def reciprocal(x, name=None):
    """``1.0 / x``: an integer x gives float64, as the reference's weak
    float does."""
    dt = result_type(x, 1.0)
    return torch.reciprocal(x.to(dt))


# --- binary -----------------------------------------------------------------
def _binary(tfn, name, inexact_result=False, doc=None):
    def op(x, y, name=None):
        _, _, (a, b) = promote(x, y, inexact_result=inexact_result)
        return tfn(a, b)
    op.__name__ = name
    op.__doc__ = doc or f"``{tfn.__name__}`` of x and y after the " \
                        "reference's promotion."
    __all__.append(name)
    return op


def _int_safe(fn):
    """fn(a, b) with an integer divisor of 0 read as 1, as jnp's
    remainder reads it."""
    def op(a, b):
        if not (b.is_floating_point() or b.is_complex()):
            b = torch.where(b == 0, torch.ones_like(b), b)
        return fn(a, b)
    op.__name__ = fn.__name__
    return op


add = _binary(torch.add, "add")
subtract = _binary(torch.sub, "subtract")
multiply = _binary(torch.mul, "multiply")
divide = _binary(torch.div, "divide", inexact_result=True)
floor_divide = _binary(torch.floor_divide, "floor_divide")
remainder = _binary(_int_safe(torch.remainder), "remainder")
mod = remainder
__all__.append("mod")
floor_mod = remainder
__all__.append("floor_mod")


def _integer_pow(a, n: int):
    """lax.integer_pow: repeated squaring, the reciprocal for n < 0."""
    acc, base, k = None, a, builtins.abs(n)
    while k:
        if k & 1:
            acc = base if acc is None else acc * base
        k >>= 1
        if k:
            base = base * base
    if acc is None:
        acc = torch.ones_like(a)
    return torch.reciprocal(acc) if n < 0 else acc


@_export
def pow(x, y, name=None):
    """x ** y; a Python int exponent is taken by repeated squaring, as
    jnp.power takes it."""
    if isinstance(y, int) and not isinstance(y, bool) and \
            isinstance(x, torch.Tensor):
        return _integer_pow(x, y)
    _, _, (a, b) = promote(x, y)
    return torch.pow(a, b)


maximum = _binary(torch.maximum, "maximum")
minimum = _binary(torch.minimum, "minimum")
fmax = _binary(lambda a, b: torch.where((a > b) | torch.isnan(b), a, b),
               "fmax", doc="The larger of x and y ignoring a NaN in y; y "
                           "at a tie.")
fmin = _binary(lambda a, b: torch.where((a < b) | torch.isnan(b), a, b),
               "fmin", doc="The smaller of x and y ignoring a NaN in y; y "
                           "at a tie.")
atan2 = _binary(torch.atan2, "atan2", inexact_result=True)
logaddexp = _binary(torch.logaddexp, "logaddexp", inexact_result=True)


@_export
def hypot(x, y, name=None):
    """``sqrt(x*x + y*y)``, each product in its operand's dtype:
    overflows to inf where x*x does."""
    def sq(v):
        return v * v if is_scalar(v) else multiply(v, v)
    return sqrt(add(sq(x), sq(y)))


@_export
def divide_no_nan(x, y, name=None):
    """x / y, and 0 where y == 0: ``where(y == 0, 0.0, x / where(y ==
    0, 1.0, y))`` (an integer y gives float64, by the weak 1.0)."""
    from paddle_tpu_torch.tensor.search import where
    if is_scalar(y):
        q = divide(x, 1.0 if y == 0 else y)
        return torch.zeros_like(q) if y == 0 else q
    zero = y == 0
    return where(zero, 0.0, divide(x, where(zero, 1.0, y)))


@_export
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (``(x + bias) * scale`` if not
    ``bias_after_scale``), cast back to x's dtype if x is not floating;
    then the activation ``act`` of ``nn.functional``."""
    out = add(multiply(x, scale), bias) if bias_after_scale else \
        multiply(add(x, bias), scale)
    if not x.is_floating_point():
        out = out.to(x.dtype)
    if act is not None:
        from paddle_tpu_torch.nn import functional as F
        out = getattr(F, act)(out)
    return out


@_export
def clip(x, min=None, max=None, name=None):
    """``minimum(max, maximum(min, x))``: a gradient at a bound is
    halved, as the reference's."""
    if min is not None:
        x = maximum(min, x)
    if max is not None:
        x = minimum(max, x)
    return x


@_export
def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)``."""
    return add(x, multiply(weight, subtract(y, x)))


@_export
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """``beta * input + alpha * (x @ y)``."""
    from paddle_tpu_torch.tensor.linalg import matmul
    return add(multiply(beta, input), multiply(alpha, matmul(x, y)))


@_export
def multiplex(inputs, index, name=None):
    """Row i of the output is row i of ``inputs[index[i]]``."""
    stacked = torch.stack(list(inputs), 0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[index.reshape(-1).long(), rows]


@_export
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return multiply(scale_b, tanh(multiply(scale_a, x)))


@_export
def kron(x, y, name=None):
    _, _, (a, b) = promote(x, y)
    return torch.kron(a, b)


@_export
def inner(x, y, name=None):
    _, _, (a, b) = promote(x, y)
    return torch.inner(a, b)


@_export
def outer(x, y, name=None):
    """The outer product of x and y flattened."""
    _, _, (a, b) = promote(x, y)
    return a.reshape(-1, 1) * b.reshape(1, -1)


@_export
def cross(x, y, axis=None, name=None):
    """The cross product along ``axis`` (-1 when None, the reference's
    default), by jnp's formula."""
    _, _, (a, b) = promote(x, y)
    ax = -1 if axis is None else axis
    a, b = a.movedim(ax, -1), b.movedim(ax, -1)
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    c = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                     a0 * b1 - a1 * b0])
    return c.movedim(0, ax)


@_export
def dot(x, y, name=None):
    """``sum(x * y)`` over the last axis."""
    p = multiply(x, y)
    return p.sum(-1, dtype=sum_dtype(p.dtype))


# --- reductions -------------------------------------------------------------
@_export
def sum(x, axis=None, keepdim=False, name=None):
    """Sum; bool and integers up to 32 bits accumulate in int64."""
    dt = sum_dtype(x.dtype)
    dims = reduce_dims(axis, x.ndim)
    if not dims and x.ndim:
        return x.to(dt)
    return torch.sum(x, dim=dims, keepdim=keepdim, dtype=dt)


def _flat_reduce(x, axis, keepdim, fn):
    """fn(x', -1) where x' has the reduced axes moved last and
    flattened: for the PyTorch reductions that take one dim."""
    dims = reduce_dims(axis, x.ndim)
    if x.ndim == 0:
        return fn(x.reshape(1), -1).reshape(())
    flat, keep = moved_flat(x, dims)
    out = fn(flat, -1)
    if keepdim:
        out = out.reshape(keepdim_shape(x.shape, dims))
    return out


@_export
def prod(x, axis=None, keepdim=False, name=None):
    """Product; bool and integers up to 32 bits accumulate in int64."""
    dt = sum_dtype(x.dtype)
    return _flat_reduce(x, axis, keepdim,
                        lambda t, d: torch.prod(t, d, dtype=dt))


def _extreme(tfn, bool_fn, name):
    def op(x, axis=None, keepdim=False, name=None):
        dims = reduce_dims(axis, x.ndim)
        if x.dtype == torch.bool:
            return _flat_reduce(x, axis, keepdim, bool_fn)
        if not dims:
            return x.clone()
        return tfn(x, dim=dims, keepdim=keepdim)
    op.__name__ = name
    op.__doc__ = f"``{tfn.__name__}``: a tied gradient splits evenly."
    __all__.append(name)
    return op


max = _extreme(torch.amax, torch.any, "max")
min = _extreme(torch.amin, torch.all, "min")
amax = _extreme(torch.amax, torch.any, "amax")
amin = _extreme(torch.amin, torch.all, "amin")


@_export
def mean(x, axis=None, keepdim=False, name=None):
    """Mean, of an integer x in float32 (int64: float64)."""
    x = x.to(inexact(x.dtype))
    dims = reduce_dims(axis, x.ndim)
    if not dims:
        return x.clone()
    return torch.mean(x, dim=dims, keepdim=keepdim)


@_export
def nanmean(x, axis=None, keepdim=False, name=None):
    x = x.to(inexact(x.dtype))
    return torch.nanmean(x, dim=reduce_dims(axis, x.ndim), keepdim=keepdim)


@_export
def nansum(x, axis=None, keepdim=False, name=None):
    if not x.is_floating_point():
        return sum(x, axis, keepdim)
    return torch.nansum(x, dim=reduce_dims(axis, x.ndim), keepdim=keepdim)


@_export
def logsumexp(x, axis=None, keepdim=False, name=None):
    """``log(sum(exp(x)))`` shifted by the finite maximum: a row of -inf
    gives -inf (and a NaN gradient, as the reference's)."""
    x = x.to(inexact(x.dtype))
    return torch.logsumexp(x, dim=reduce_dims(axis, x.ndim),
                           keepdim=keepdim)


@_export
def all(x, axis=None, keepdim=False, name=None):
    return _flat_reduce(x.bool(), axis, keepdim, torch.all)


@_export
def any(x, axis=None, keepdim=False, name=None):
    return _flat_reduce(x.bool(), axis, keepdim, torch.any)


@_export
def count_nonzero(x, axis=None, keepdim=False, name=None):
    """The number of nonzero entries, int64."""
    return _flat_reduce(x, axis, keepdim,
                        lambda t, d: torch.count_nonzero(t, dim=d))


def _cum_dtype(x, dtype):
    if dtype is not None:
        return convert_dtype(dtype)
    return torch.int64 if x.dtype == torch.bool else x.dtype


@_export
def cumsum(x, axis=None, dtype=None, name=None):
    """Cumulative sum along ``axis`` (of x flattened for None) in
    ``dtype`` (x's dtype, int64 for bool)."""
    dt = _cum_dtype(x, dtype)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dt)
    return torch.cumsum(x, int(axis), dtype=dt)


@_export
def cumprod(x, dim=None, dtype=None, name=None):
    """Cumulative product along ``dim`` (of x flattened for None)."""
    dt = _cum_dtype(x, dtype)
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=dt)
    return torch.cumprod(x, int(dim), dtype=dt)


def _cum_extreme(x, axis, tfn, newer):
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % builtins.max(x.ndim, 1)
    running = tfn(x.detach(), axis).values
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    iota = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    cand = torch.where(newer(x.detach(), running), iota,
                       torch.zeros_like(iota))
    idx = torch.cummax(cand, axis).values
    return x.gather(axis, idx), idx


@_export
def cummax(x, axis=None, dtype="int64", name=None):
    """(running maximum, int64 index of its last occurrence) along
    ``axis``; the values' gradient goes to that index."""
    return _cum_extreme(x, axis, torch.cummax, torch.ge)


@_export
def cummin(x, axis=None, dtype="int64", name=None):
    """(running minimum, int64 index of its last occurrence)."""
    return _cum_extreme(x, axis, torch.cummin, torch.le)


@_export
def isfinite(x, name=None):
    return torch.isfinite(x)


@_export
def isinf(x, name=None):
    return torch.isinf(x)


@_export
def isnan(x, name=None):
    return torch.isnan(x)


@_export
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """jnp.isclose: ``a == b`` or, for a finite b, ``|a - b| <= atol +
    rtol * |b|`` computed in the promoted float dtype."""
    dt, dev, (a, b) = promote(x, y, inexact_result=True)
    real = a.real.dtype if a.is_complex() else dt
    rt, at = cast(rtol, real, dev), cast(atol, real, dev)
    out = (a == b) | (torch.isfinite(b)
                      & ((a - b).abs() <= at + rt * b.abs()))
    if equal_nan:
        out = out | (torch.isnan(a) & torch.isnan(b))
    return out


@_export
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """:func:`isclose` everywhere, a 0-d bool tensor on the inputs'
    device."""
    return isclose(x, y, rtol, atol, equal_nan).all()


@_export
def equal_all(x, y, name=None):
    """A 0-d bool tensor: same shape and every entry equal."""
    if tuple(x.shape) != tuple(y.shape):
        return torch.full((), False, device=x.device)
    _, _, (a, b) = promote(x, y)
    return (a == b).all()


@_export
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    """The n-th difference along ``axis`` (``!=`` for bool), with
    ``prepend`` / ``append`` (a scalar broadcast to one slice) joined
    first."""
    ax = axis % x.ndim

    def edge(v):
        v = cast(v, result_type(x, v), x.device) if is_scalar(v) else \
            torch.as_tensor(v, device=x.device)
        if v.ndim == 0:
            shape = list(x.shape)
            shape[ax] = 1
            v = v.expand(shape)
        return v

    parts = ([] if prepend is None else [edge(prepend)]) + [x] + (
        [] if append is None else [edge(append)])
    if len(parts) > 1:
        dt = result_type(*parts)
        x = torch.cat([p.to(dt) for p in parts], ax)
    for _ in range(n):
        hi = x.narrow(ax, 1, x.shape[ax] - 1)
        lo = x.narrow(ax, 0, x.shape[ax] - 1)
        x = hi != lo if x.dtype == torch.bool else hi - lo
    return x


@_export
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    """The sum of diagonal ``offset``; bool and small integers in
    int64."""
    d = torch.diagonal(x, offset, axis1, axis2)
    return d.sum(-1, dtype=sum_dtype(x.dtype))


@_export
def increment(x, value=1.0, name=None):
    """x += value in place, outside autograd's tape; returns x."""
    with torch.no_grad():
        x.add_(value)
    return x


@_export
def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the k highest scores
    (ranked by the port's ``topk``: among ties the lower index first),
    a 0-d float32 tensor."""
    from paddle_tpu_torch.tensor.search import topk
    _, idx = topk(input.detach(), k)
    hit = (idx == label.reshape(-1, 1)).any(1)
    return hit.float().mean()
