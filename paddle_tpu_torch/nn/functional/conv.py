"""``conv1d``, ``conv2d`` and ``conv3d`` (port of
paddle_tpu/nn/functional/conv.py ``_conv_nd`` :48-80).

Weights are OI + spatial (the reference's layout, PyTorch's too), the
input NC + spatial or, with a channel-last ``data_format``, N + spatial +
C.  A channel-last input is handed to the convolution as a permuted view,
whose strides cuDNN reads as its NHWC layout, and the output is permuted
back.  The bias is added after the convolution, as the reference adds it.

Padding takes every form of the reference's ``_norm_padding`` (:32-46):
an int, one int per spatial dim, a flat list of ``2n`` ints (low, high
per dim), a list of (low, high) pairs, ``"SAME"`` or ``"VALID"``.
``"SAME"`` is XLA's: total padding ``max((ceil(in/s) - 1)*s + (k - 1)*d
+ 1 - in, 0)``, the smaller half low, at any stride.  Unequal pairs go
through an explicit ``F.pad``; PyTorch's convolutions pad symmetrically.

Precision: an f32 convolution on the card runs in full f32, never TF32
(cuDNN's default for convolutions), as the reference's CPU convolution
and the port's ``torch.matmul`` compute: forward and backward run inside
``_ieee_f32`` whatever ``torch.backends.cudnn.allow_tf32`` says.  bf16
and f16 convolutions accumulate in f32 (cuDNN) and round to the input's
dtype.  Transposed convolutions are not ported.
"""
from __future__ import annotations

import contextlib
import math
import numbers

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import amp_op

__all__ = ["conv1d", "conv2d", "conv3d"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _tuplify(v, n):
    if isinstance(v, numbers.Integral):
        return (int(v),) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _norm_padding(padding, n):
    """The reference's padding forms -> "SAME", "VALID" or n (low, high)
    pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, numbers.Integral):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, numbers.Integral)
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(int(q) for q in p) for p in padding]


def same_pads(sizes, kernel, strides, dilation=None):
    """XLA's "SAME" (low, high) pads of each spatial dim."""
    dilation = dilation or (1,) * len(sizes)
    pads = []
    for size, k, s, d in zip(sizes, kernel, strides, dilation):
        total = max((math.ceil(size / s) - 1) * s + (k - 1) * d + 1 - size,
                    0)
        pads.append((total // 2, total - total // 2))
    return pads


def resolve_pads(padding, sizes, kernel, strides, dilation=None):
    """(low, high) pairs for every spatial dim of an input of ``sizes``."""
    pad = _norm_padding(padding, len(sizes))
    if pad == "SAME":
        return same_pads(sizes, kernel, strides, dilation)
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if isinstance(pad, str):
        raise ValueError(f"padding {padding!r}: use 'SAME' or 'VALID'")
    return pad


def flat_pad(pads):
    """(low, high) pairs of the spatial dims -> ``F.pad``'s argument, last
    dim first."""
    return [q for lo_hi in reversed(pads) for q in lo_hi]


def channels_first(x, n):
    """N + spatial + C -> an NC + spatial view of the same storage."""
    return x.permute(0, n + 1, *range(1, n + 1))


def channels_last(x, n):
    """NC + spatial -> an N + spatial + C view of the same storage."""
    return x.permute(0, *range(2, n + 2), 1)


@contextlib.contextmanager
def _ieee_f32():
    """cuDNN's f32 convolutions in full f32 inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _F32Conv(torch.autograd.Function):
    """An f32 convolution on the card whose forward and backward both run
    without TF32 (the backward runs later, outside any caller's context)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        with _ieee_f32():
            return _CONV[x.dim() - 2](x, w, None, stride, padding, dilation,
                                      groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        n = x.dim() - 2
        with _ieee_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, list(stride), list(padding), list(dilation),
                False, [0] * n, groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             channel_last):
    strides = _tuplify(stride, n)
    dil = _tuplify(dilation, n)
    if channel_last:
        x = channels_first(x, n)
    pads = resolve_pads(padding, tuple(x.shape[2:]),
                        tuple(weight.shape[2:]), strides, dil)
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x, sym = F.pad(x, flat_pad(pads)), (0,) * n
    if x.is_cuda and x.dtype == torch.float32:
        out = _F32Conv.apply(x, weight, strides, sym, dil, groups)
    else:
        out = _CONV[n](x, weight, None, strides, sym, dil, groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return channels_last(out, n) if channel_last else out


@amp_op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format == "NLC")


@amp_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format == "NHWC")


@amp_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format == "NDHWC")
