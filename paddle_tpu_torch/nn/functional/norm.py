"""``layer_norm`` and ``batch_norm`` (port of
paddle_tpu/nn/functional/norm.py :13-113).

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

``F.batch_norm`` is not used: it takes one statistic pass of its own and
refuses some of the O2 mixes (bf16 input and weight, f32 running stats).
In evaluation the running stats are cast to the input's dtype before they
normalise it; the reference instead promotes a bf16 input to f32 there,
and its next convolution then refuses the mixed dtypes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import amp_op
from paddle_tpu_torch.framework.replay import replaying

__all__ = ["layer_norm", "batch_norm"]


@amp_op("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Layer normalisation over the trailing ``normalized_shape`` dims
    (reference ``:113``), statistics in f32 for a bf16 input."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def _mean_var(a, axes):
    """(mean, variance) over ``axes``, accumulated in f32 and rounded to
    a's dtype (reference ``_mean_var_1pass``)."""
    af = a.float()
    if any(a.shape[ax] == 0 for ax in axes):
        m = af.mean(axes)
        return m.to(a.dtype), torch.zeros_like(m).to(a.dtype)
    m = af.mean(axes, keepdim=True)
    if a.dtype in (torch.float32, torch.float64):
        v = (af - m).square().mean(axes, keepdim=True)
    else:
        v = ((af * af).mean(axes, keepdim=True) - m * m).clamp_min(0.0)
    return m.squeeze(axes).to(a.dtype), v.squeeze(axes).to(a.dtype)


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
    if use_batch_stats:
        m, v = _mean_var(x, axes)
    else:
        m, v = running_mean.to(x.dtype), running_var.to(x.dtype)
    out = (x - m.reshape(shape)) * torch.rsqrt(v.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if use_batch_stats and running_mean is not None and not replaying():
        n = 1
        for ax in axes:
            n *= x.shape[ax]
        with torch.no_grad():
            unbiased = v.detach() * (n / max(n - 1, 1))
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * m.detach())
            running_var.copy_(momentum * running_var
                              + (1 - momentum) * unbiased)
    return out
