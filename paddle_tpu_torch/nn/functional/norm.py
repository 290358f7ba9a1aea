"""The norm functionals (port of paddle_tpu/nn/functional/norm.py):
``layer_norm``, ``batch_norm`` (:13-113), ``instance_norm``,
``group_norm``, ``local_response_norm`` and ``normalize`` (:137-213).

``batch_norm`` is written from tensor ops, with the reference's numerics:

- batch statistics are accumulated in f32 and rounded to the input's
  dtype: an f32 (or f64) input takes the two-pass ``mean((x - m)^2)``, a
  bf16 or f16 input the one-pass ``E[x^2] - E[x]^2`` clamped at 0
  (``_mean_var_1pass`` :16-45), and the gradient flows through them;
- normalisation runs in the input's dtype, so under AMP O2 the bf16
  weight and bias meet bf16 statistics;
- in training (and not ``use_global_stats``) the running stats update in
  place, off autograd's tape: ``running = momentum * running + (1 -
  momentum) * stat`` with Paddle's momentum (0.9 keeps 90 %; PyTorch's
  ``momentum`` is the complement) and the unbiased variance ``v * n / (n -
  1)``.  A bf16 statistic adds into f32 buffers, which stay f32.

Inside :func:`batch_stats_over` (``parallel.sharded.ShardedTrainStep``
opens it around each rank's forward) a training batch norm takes the
statistics of the global batch, whose equal slices the ranks hold: the
per-channel sums (and sums of squared deviations) of the rank's slice go
through the given differentiable sum over the ranks, then divide by the
global count; the running statistics update from those.  As on one rank,
the statistics accumulate in f32 whatever the input's dtype (reference
``_mean_var_1pass``), an f64 input's too.

``F.batch_norm`` is not used: it takes one statistic pass of its own and
refuses some of the O2 mixes (bf16 input and weight, f32 running stats).
In evaluation the running stats are cast to the input's dtype before they
normalise it; the reference instead promotes a bf16 input to f32 there,
and its next convolution then refuses the mixed dtypes.

``instance_norm`` and ``group_norm`` take their statistics from the same
``_mean_var``.  Both are the reference's, quirks included: ``instance_norm``
reads neither running statistics nor ``use_input_stats``, ``momentum`` and
``data_format`` (it always normalises dims 2.. of an NC... input), and in
both a ``bias`` given without a ``weight`` scales the output as a weight
would (the reference hands the tensors present to one list, weight
first).  ``local_response_norm`` divides by ``(k + alpha * sum)^beta`` over
``size`` channels zero-padded by (size // 2, size - size // 2 - 1), alpha
not divided by ``size`` as ``torch.nn.functional.local_response_norm``
divides it; ``normalize`` at p = 2 is ``x / max(sqrt(sum(x * x)),
epsilon)`` (an all-zero row's gradient is NaN, in both packages).
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import amp_op
from paddle_tpu_torch.framework.replay import replaying

__all__ = ["layer_norm", "batch_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize", "batch_stats_over"]

_STATS = threading.local()


@contextlib.contextmanager
def batch_stats_over(reduce_sum, ranks: int):
    """Inside, a training batch norm normalises by the statistics of a
    batch cut into ``ranks`` equal slices, this thread's rank holding one:
    ``reduce_sum(t)`` returns the sum of ``t`` over the ranks, with its
    gradient."""
    prev = getattr(_STATS, "over", None)
    _STATS.over = (reduce_sum, int(ranks))
    try:
        yield
    finally:
        _STATS.over = prev


@amp_op("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Layer normalisation over the trailing ``normalized_shape`` dims
    (reference ``:113``), statistics in f32 for a bf16 input."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def _mean_var(a, axes, keepdims=False):
    """(mean, variance) over ``axes``, accumulated in f32 and rounded to
    a's dtype (reference ``_mean_var_1pass``)."""
    af = a.float()
    if any(a.shape[ax] == 0 for ax in axes):
        m = af.mean(axes, keepdim=keepdims)
        return m.to(a.dtype), torch.zeros_like(m).to(a.dtype)
    m = af.mean(axes, keepdim=True)
    if a.dtype in (torch.float32, torch.float64):
        v = (af - m).square().mean(axes, keepdim=True)
    else:
        v = ((af * af).mean(axes, keepdim=True) - m * m).clamp_min(0.0)
    if not keepdims:
        m, v = m.squeeze(axes), v.squeeze(axes)
    return m.to(a.dtype), v.to(a.dtype)


def _global_mean_var(a, axes, reduce_sum, ranks):
    """``_mean_var`` over the global batch of ``ranks`` equal slices, a
    of this rank's: its numerics, the sums taken across the ranks."""
    af = a.float()
    n = math.prod(a.shape[ax] for ax in axes) * ranks
    if a.dtype in (torch.float32, torch.float64):
        m = reduce_sum(af.sum(axes)) / n
        shape = [1] * a.dim()
        c_axis = next(i for i in range(a.dim()) if i not in axes)
        shape[c_axis] = a.shape[c_axis]
        v = reduce_sum((af - m.reshape(shape)).square().sum(axes)) / n
    else:
        s = reduce_sum(torch.stack([af.sum(axes), (af * af).sum(axes)]))
        m = s[0] / n
        v = (s[1] / n - m * m).clamp_min(0.0)
    return m.to(a.dtype), v.to(a.dtype)


@amp_op("batch_norm")
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalisation over every dim but the channel's (the last one
    for NHWC, NLC and NDHWC, else dim 1); updates ``running_mean`` and
    ``running_var`` in place when it normalises by the batch's
    statistics, once: not again in the backward's replay of a recompute
    region (``framework.replay.replaying``)."""
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    use_batch_stats = training and not use_global_stats
    c_axis = x.dim() - 1 if channel_last else (1 if x.dim() > 1 else 0)
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    over = getattr(_STATS, "over", None) if use_batch_stats else None
    if over is not None:
        m, v = _global_mean_var(x, axes, *over)
    elif use_batch_stats:
        m, v = _mean_var(x, axes)
    else:
        m, v = running_mean.to(x.dtype), running_var.to(x.dtype)
    out = (x - m.reshape(shape)) * torch.rsqrt(v.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if use_batch_stats and running_mean is not None and not replaying():
        n = math.prod(x.shape[ax] for ax in axes) * (
            1 if over is None else over[1])
        with torch.no_grad():
            unbiased = v.detach() * (n / max(n - 1, 1))
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * m.detach())
            running_var.copy_(momentum * running_var
                              + (1 - momentum) * unbiased)
    return out


@functools.lru_cache(maxsize=256)
def _weak(value, dtype):
    """A Python number rounded to ``dtype``, as JAX rounds a weakly typed
    scalar before it meets an array of that dtype."""
    return float(torch.tensor(value, dtype=dtype))


class _Rsqrt(torch.autograd.Function):
    """``rsqrt`` with JAX's derivative, ``g * (-0.5 * y / x)``: PyTorch's
    ``-0.5 * g * y^3`` rounds a bf16 gradient differently."""

    @staticmethod
    def forward(ctx, x):
        y = torch.rsqrt(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (-0.5 * (y / x))


def _normalised(a, axes, eps):
    m, v = _mean_var(a, axes, keepdims=True)
    return (a - m) * _Rsqrt.apply(v + _weak(eps, a.dtype))


def _affine(out, weight, bias):
    """``out`` scaled and shifted per channel (dim 1) by the tensors
    present, the first as the scale, as the reference hands them on."""
    wb = [t for t in (weight, bias) if t is not None]
    shape = [1, out.shape[1]] + [1] * (out.dim() - 2)
    if wb:
        out = out * wb[0].reshape(shape)
    if len(wb) > 1:
        out = out + wb[1].reshape(shape)
    return out


@amp_op("instance_norm")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalisation of each (sample, channel) over dims 2.. (reference
    ``:137``)."""
    return _affine(_normalised(x, tuple(range(2, x.dim())), eps), weight,
                   bias)


@amp_op("group_norm")
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalisation of each sample over ``num_groups`` groups of channels
    and every spatial dim (reference ``:160``); the channel is the last
    dim for NHWC, NDHWC and NLC, else dim 1."""
    channel_last = data_format in ("NHWC", "NDHWC", "NLC")
    a = x.movedim(-1, 1) if channel_last else x
    n, c = a.shape[:2]
    grouped = a.reshape((n, num_groups, c // num_groups) + a.shape[2:])
    out = _affine(_normalised(grouped, tuple(range(2, grouped.dim())),
                              epsilon).reshape(a.shape), weight, bias)
    return out.movedim(1, -1) if channel_last else out


@amp_op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s)^beta``, s the sum of x^2 over a window of
    ``size`` channels (reference ``:189-203``)."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    half = size // 2
    sq = (x * x).movedim(c_axis, -1)
    summed = F.pad(sq, (half, size - half - 1)).unfold(-1, size, 1).sum(-1)
    k, alpha, beta = (_weak(c, x.dtype) for c in (k, alpha, beta))
    return x / torch.pow(k + alpha * summed.movedim(-1, c_axis), beta)


@amp_op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` divided by its p-norm along ``axis``, the norm held at or above
    ``epsilon`` (reference ``:206-213``)."""
    if p == 2:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        n = torch.sum(x.abs() ** p, dim=axis, keepdim=True) ** _weak(
            1.0 / p, x.dtype)
    return x / n.clamp_min(_weak(epsilon, x.dtype))
