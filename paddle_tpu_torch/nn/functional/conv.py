"""``conv1d``, ``conv2d`` and ``conv3d`` (port of
paddle_tpu/nn/functional/conv.py ``_conv_nd`` :48-80) and their
transposes ``conv{1,2,3}d_transpose`` (``_conv_transpose_nd`` :101-179).

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
dtype.

A transposed convolution's weight is (in, out / groups) + kernel, the
reference's layout and PyTorch's.  The reference runs it as a
convolution of the stride-dilated input with the flipped kernel, padded
``(k_eff - 1 - low, k_eff - 1 - high + output_padding)`` a dim; that is
the full transposed output (PyTorch's at padding 0) cut by ``low`` at
the start and by ``high - output_padding`` at the end, zeros where the
cut is negative.  Symmetric pads go to PyTorch's own padding; other
pairs cut the full output with ``F.pad``.  A string padding is laid out
by lax on the undilated input: ``"SAME"`` pads ``k_eff - 1`` (the
smaller half low), ``"VALID"`` nothing, ``output_padding`` is not read,
and a stride above 1 raises ``ValueError`` as lax does.  ``output_size``
is read by nothing in the reference: the port accepts it where it equals
the size computed anyway and raises ``NotImplementedError`` otherwise.
"""
from __future__ import annotations

import contextlib
import math
import numbers

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import amp_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


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
    """cuDNN's f32 convolutions and cuBLAS's f32 products in full f32
    inside the block."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


class _F32Conv(torch.autograd.Function):
    """An f32 convolution (or, with ``output_padding`` given, a transposed
    one) on the card whose forward and backward both run without TF32
    (the backward runs later, outside any caller's context)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups,
                output_padding=None):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, output_padding)
        n = x.dim() - 2
        with _ieee_f32():
            if output_padding is None:
                return _CONV[n](x, w, None, stride, padding, dilation,
                                groups)
            return _CONV_T[n](x, w, None, stride, padding, output_padding,
                              groups, dilation)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, output_padding = ctx.conf
        n = x.dim() - 2
        transposed = output_padding is not None
        with _ieee_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, list(stride), list(padding), list(dilation),
                transposed, list(output_padding or (0,) * n), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None, None


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


def _transpose_pads(padding, n, k_eff, strides, out_pad):
    """(low, high) cuts of the full transposed output a dim: the
    reference's explicit pads with ``output_padding`` taken off the high
    side, or lax's layout of a string padding (module docstring)."""
    pad = _norm_padding(padding, n)
    if not isinstance(pad, str):
        return [(lo, hi - op) for (lo, hi), op in zip(pad, out_pad)]
    if any(s != 1 for s in strides):
        raise ValueError(
            "String padding is not implemented for transposed convolution "
            "using this op. Please either exactly specify the required "
            "padding or use conv_transpose.")
    if pad == "VALID":
        return [(k - 1, k - 1) for k in k_eff]
    if pad != "SAME":
        raise ValueError(f"padding {padding!r}: use 'SAME' or 'VALID'")
    # lax's SAME at stride 1 on the undilated input pads k_eff - 1
    return [(k - 1 - (k - 1) // 2, k - 1 - (k - 1 - (k - 1) // 2))
            for k in k_eff]


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n, channel_last, output_size):
    strides = _tuplify(stride, n)
    dil = _tuplify(dilation, n)
    out_pad = _tuplify(output_padding, n) if output_padding is not None \
        else (0,) * n
    if channel_last:
        x = channels_first(x, n)
    sizes = tuple(x.shape[2:])
    k_eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dil)]
    cuts = _transpose_pads(padding, n, k_eff, strides, out_pad)
    full = [(i - 1) * s + k for i, s, k in zip(sizes, strides, k_eff)]
    out_sizes = [f - lo - hi for f, (lo, hi) in zip(full, cuts)]
    if output_size is not None:
        asked = [int(v) for v in (output_size if isinstance(
            output_size, (list, tuple)) else [output_size] * n)][-n:]
        if asked != out_sizes:
            raise NotImplementedError(
                f"output_size={output_size!r}: the reference reads no "
                f"output_size and gives {out_sizes}; the port takes only "
                "that size")
    # PyTorch's own padding p cuts p at each end and output_padding q < max
    # (stride, dilation) takes q back at the high end
    native = all(lo >= 0 and lo - hi < max(s, d)
                 and hi <= lo for (lo, hi), s, d in zip(cuts, strides, dil))
    sym = tuple(lo for lo, _ in cuts) if native else (0,) * n
    opad = tuple(lo - hi for lo, hi in cuts) if native else (0,) * n
    if x.is_cuda and x.dtype == torch.float32:
        out = _F32Conv.apply(x, weight, strides, sym, dil, groups, opad)
    else:
        out = _CONV_T[n](x, weight, None, strides, sym, opad, groups, dil)
    if not native:
        out = F.pad(out, [-q for lo_hi in reversed(cuts) for q in lo_hi])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return channels_last(out, n) if channel_last else out


@amp_op("conv1d_transpose")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format == "NLC", output_size)


@amp_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format == "NHWC", output_size)


@amp_op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format == "NDHWC", output_size)
