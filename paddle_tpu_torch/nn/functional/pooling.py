"""``max_pool2d``, ``avg_pool2d`` and ``adaptive_avg_pool2d`` (port of
paddle_tpu/nn/functional/pooling.py ``_pool`` :53-91 and
``_adaptive_pool`` :231-262), NCHW and NHWC.

Padding takes the reference's forms (``_norm_pad`` :23-36, the
convolution's, ``"SAME"`` and ``"VALID"`` included).  A window sees the
padding as -inf (max) or 0 (sum):

- ``ceil_mode`` widens the high side by the reference's clamp (``:39-50``):
  an extra output only where the last window starts inside the input plus
  its low padding;
- ``avg_pool2d(exclusive=True)`` (the default) divides each window's sum by
  the count of input cells in it, leaving padding out; ``exclusive=False``
  divides by the window's size, the ceil-mode cells included.  With a
  string padding the reference divides by the window's size either way,
  and so does the port;
- adaptive bins are ``[floor(i*in/o), ceil((i+1)*in/o))`` (``:255-258``),
  averaged one spatial dim after the other, as the reference does.

Not ported, raising ``NotImplementedError``: ``return_mask=True`` and
``divisor_override`` (which the reference accepts and ignores).  The 1-D
and 3-D pools and the adaptive max pools are not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import amp_op
from paddle_tpu_torch.nn.functional.conv import (_tuplify, channels_first,
                                                 channels_last, flat_pad,
                                                 resolve_pads)

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]


def _ceil_extra_pad(size, p0, p1, k, s):
    """Extra high-side padding for ceil_mode: one more window only if it
    starts inside the input and its low padding (reference ``:39``)."""
    span = size + p0 + p1 - k
    n_floor = span // s + 1
    n_ceil = -(-span // s) + 1
    if n_ceil > n_floor and (n_ceil - 1) * s < size + p0:
        return (n_ceil - 1) * s + k - (size + p0 + p1)
    return 0


def _pool2d(x, kernel, stride, padding, channel_last, mode, ceil_mode,
            exclusive):
    k = _tuplify(kernel, 2)
    s = _tuplify(stride if stride is not None else kernel, 2)
    if channel_last:
        x = channels_first(x, 2)
    sizes = tuple(x.shape[2:])
    pads = resolve_pads(padding, sizes, k, s)
    named = isinstance(padding, str)
    if ceil_mode and not named:
        pads = [(p0, p1 + _ceil_extra_pad(size, p0, p1, k[i], s[i]))
                for i, (size, (p0, p1)) in enumerate(zip(sizes, pads))]
    if mode == "max":
        if all(lo == hi and 0 <= lo <= kk // 2
               for (lo, hi), kk in zip(pads, k)):
            # PyTorch's own padding is -inf, up to half the window
            out = F.max_pool2d(x, k, s, [lo for lo, _ in pads])
        else:
            out = F.max_pool2d(F.pad(x, flat_pad(pads), value=-math.inf),
                               k, s)
    else:
        summed = F.avg_pool2d(F.pad(x, flat_pad(pads)), k, s,
                              divisor_override=1)
        if exclusive and not named:
            ones = torch.ones((1, 1) + sizes, dtype=x.dtype, device=x.device)
            counts = F.avg_pool2d(F.pad(ones, flat_pad(pads)), k, s,
                                  divisor_override=1)
            out = summed / counts
        else:
            out = summed / float(k[0] * k[1])
    return channels_last(out, 2) if channel_last else out


@amp_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported")
    return _pool2d(x, kernel_size, stride, padding, data_format == "NHWC",
                   "max", ceil_mode, True)


@amp_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    if divisor_override is not None:
        raise NotImplementedError(
            "avg_pool2d(divisor_override=...): the reference ignores it, "
            "the port does not pool by another divisor without it")
    return _pool2d(x, kernel_size, stride, padding, data_format == "NHWC",
                   "avg", ceil_mode, exclusive)


@amp_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over adaptive bins, height then width (reference ``:276``); an
    output size of None keeps that dim."""
    out_sizes = _tuplify(output_size, 2) if not isinstance(
        output_size, (list, tuple)) else tuple(output_size)
    start = 1 if data_format == "NHWC" else 2
    out = x
    for d, o in enumerate(out_sizes):
        axis = start + d
        size = x.shape[axis]
        o = size if o is None else int(o)
        if size % o == 0:
            out = out.unflatten(axis, (o, size // o)).mean(axis + 1)
        else:
            out = torch.cat([out.narrow(axis, (i * size) // o,
                                        -(-((i + 1) * size) // o)
                                        - (i * size) // o
                                        ).mean(axis, keepdim=True)
                             for i in range(o)], dim=axis)
    return out
