"""Pooling (port of paddle_tpu/nn/functional/pooling.py): the max and
average pools in 1, 2 and 3 dims (``_pool`` :53-91), the masked max pool
and ``max_unpool2d`` (``:94-202``) and the adaptive pools
(``:231-328``), channel-first and, where the reference takes a
``data_format``, channel-last.

Padding takes the reference's forms (``_norm_pad`` :23-36, the
convolution's, ``"SAME"`` and ``"VALID"`` included).  A window sees the
padding as -inf (max) or 0 (sum):

- ``ceil_mode`` widens the high side by the reference's clamp (``:39-50``):
  an extra output only where the last window starts inside the input plus
  its low padding;
- ``avg_pool*(exclusive=True)`` (the default) divides each window's sum by
  the count of input cells in it, leaving padding out; ``exclusive=False``
  divides by the window's size, the ceil-mode cells included.  With a
  string padding the reference divides by the window's size either way,
  and so does the port;
- adaptive bins are ``[floor(i*in/o), ceil((i+1)*in/o))`` (``:255-258``),
  reduced one spatial dim after the other, as the reference does.  An
  adaptive max pool therefore splits the gradient of a tie among the tied
  cells of each dim in turn (JAX's max), as ``amax`` does.

The masked max pool (``return_mask=True``, NCHW) stacks the ``kh * kw``
strided window slices of the -inf padded input, as the reference does:
the mask holds flat ``H * W`` indices into the unpadded input of the first
maximum in window order (int32), and the gradient of a window's maximum
splits evenly among its tied cells (``amax``'s rule and JAX's), where the
unmasked pool gives it to the first.  ``max_unpool2d`` scatters the values
back; where two windows recorded one index, the last in flattened order
wins, value and gradient, as the reference's scatter does on the CPU, and
an index outside the map is dropped (a negative one counts from the end).

Raising as the reference raises: ``return_mask`` on NHWC (``ValueError``)
and with a string padding (``ValueError``), on ``max_pool3d`` and
``adaptive_max_pool3d``, and on an adaptive max pool whose input does not
divide by its output (``NotImplementedError``).  Not copied, raising
``NotImplementedError``: ``divisor_override`` (the reference accepts and
ignores it) and a ``max_unpool2d`` ``data_format`` other than NCHW (the
reference reads the input as NCHW whatever it says).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import amp_op
from paddle_tpu_torch.nn.functional.conv import (_norm_padding, _tuplify,
                                                 channels_first,
                                                 channels_last, flat_pad,
                                                 resolve_pads)

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool2d"]

_MAX = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _ceil_extra_pad(size, p0, p1, k, s):
    """Extra high-side padding for ceil_mode: one more window only if it
    starts inside the input and its low padding (reference ``:39``)."""
    span = size + p0 + p1 - k
    n_floor = span // s + 1
    n_ceil = -(-span // s) + 1
    if n_ceil > n_floor and (n_ceil - 1) * s < size + p0:
        return (n_ceil - 1) * s + k - (size + p0 + p1)
    return 0


def _pool(x, kernel, stride, padding, n, channel_last, mode, ceil_mode,
          exclusive):
    k = _tuplify(kernel, n)
    s = _tuplify(stride if stride is not None else kernel, n)
    if channel_last:
        x = channels_first(x, n)
    sizes = tuple(x.shape[2:])
    pads = resolve_pads(padding, sizes, k, s)
    named = isinstance(padding, str)
    if ceil_mode and not named:
        pads = [(p0, p1 + _ceil_extra_pad(size, p0, p1, k[i], s[i]))
                for i, (size, (p0, p1)) in enumerate(zip(sizes, pads))]
    if n == 1:      # PyTorch's 1-D average pool has no divisor_override
        x, sizes = x.unsqueeze(-1), sizes + (1,)
        k, s, pads = k + (1,), s + (1,), list(pads) + [(0, 0)]
    nd = len(k)
    if mode == "max":
        if all(lo == hi and 0 <= lo <= kk // 2
               for (lo, hi), kk in zip(pads, k)):
            # PyTorch's own padding is -inf, up to half the window
            out = _MAX[nd](x, k, s, [lo for lo, _ in pads])
        else:
            out = _MAX[nd](F.pad(x, flat_pad(pads), value=-math.inf), k, s)
    else:
        summed = _AVG[nd](F.pad(x, flat_pad(pads)), k, s,
                          divisor_override=1)
        if exclusive and not named:
            ones = torch.ones((1, 1) + sizes, dtype=x.dtype, device=x.device)
            counts = _AVG[nd](F.pad(ones, flat_pad(pads)), k, s,
                              divisor_override=1)
            out = summed / counts
        else:
            out = summed / float(math.prod(k))
    if n == 1:
        out = out.squeeze(-1)
    return channels_last(out, n) if channel_last else out


def _n_out(size, p0, p1, k, s, ceil_mode):
    span = size + p0 + p1 - k
    n = (-(-span // s) if ceil_mode else span // s) + 1
    # ceil-mode clamp: the last window starts inside input + low padding
    if ceil_mode and n > span // s + 1 and (n - 1) * s >= size + p0:
        n -= 1
    return n


def _max_pool2d_with_mask(x, kernel, stride, padding, ceil_mode=False):
    """(max, flat H*W index of the first maximum) of each window, NCHW
    (reference ``:94-145``)."""
    kh, kw = _tuplify(kernel, 2)
    sh, sw = _tuplify(stride if stride is not None else kernel, 2)
    pad = _norm_padding(padding, 2)
    if isinstance(pad, str):
        raise ValueError("return_mask needs explicit int padding")
    (pt, pb), (pl, pr) = pad
    _, _, h, w = x.shape
    oh = _n_out(h, pt, pb, kh, sh, ceil_mode)
    ow = _n_out(w, pl, pr, kw, sw, ceil_mode)
    # ceil mode may need the high padding widened so that every window has
    # backing data (-inf, never the maximum)
    pb = max(pb, (oh - 1) * sh + kh - h - pt)
    pr = max(pr, (ow - 1) * sw + kw - w - pl)
    padded = F.pad(x, [pl, pr, pt, pb], value=-math.inf)
    stack = torch.stack([padded[:, :, i:i + sh * oh:sh, j:j + sw * ow:sw]
                         for i in range(kh) for j in range(kw)])
    out = stack.amax(0)
    kk = kh * kw
    order = torch.arange(kk, device=x.device).view(kk, 1, 1, 1, 1)
    first = torch.where((stack == out) | stack.isnan(), order, kk).amin(0)
    gy = torch.arange(oh, device=x.device) * sh - pt
    gx = torch.arange(ow, device=x.device) * sw - pl
    i, j = first.div(kw, rounding_mode="floor"), first.remainder(kw)
    mask = (gy.view(-1, 1) + i) * w + gx.view(1, -1) + j
    return out, mask.to(torch.int32)


@amp_op("max_pool1d")
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if not return_mask:
        return _pool(x, kernel_size, stride, padding, 1,
                     data_format == "NLC", "max", ceil_mode, True)
    if data_format == "NLC":
        x = x.transpose(1, 2)
    k = _tuplify(kernel_size, 1) + (1,)
    s = _tuplify(stride if stride is not None else kernel_size, 1) + (1,)
    p = _tuplify(padding, 1) + (0,)
    out, mask = _max_pool2d_with_mask(x.unsqueeze(-1), k, s, list(p),
                                      ceil_mode)
    out, mask = out.squeeze(-1), mask.squeeze(-1)
    if data_format == "NLC":
        return out.transpose(1, 2), mask.transpose(1, 2)
    return out, mask


@amp_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if not return_mask:
        return _pool(x, kernel_size, stride, padding, 2,
                     data_format == "NHWC", "max", ceil_mode, True)
    if data_format != "NCHW":
        raise ValueError("return_mask supports NCHW")
    return _max_pool2d_with_mask(x, kernel_size, stride, padding, ceil_mode)


@amp_op("max_pool3d")
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        raise NotImplementedError(
            "max_pool3d(return_mask=True) is not implemented, as in the "
            "reference; use max_pool2d")
    return _pool(x, kernel_size, stride, padding, 3, data_format == "NDHWC",
                 "max", ceil_mode, True)


@amp_op("max_unpool2d")
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """The values of ``x`` at the flat H*W positions ``indices`` of a zero
    (N, C, H, W) map (reference ``:181-202``); H, W from ``output_size`` or
    ``(o - 1) * s - 2 * p + k``."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"max_unpool2d(data_format={data_format!r}): the reference "
            "reads every input as NCHW; the port takes NCHW only")
    kh, kw = _tuplify(kernel_size, 2)
    sh, sw = _tuplify(stride if stride is not None else kernel_size, 2)
    ph, pw = _tuplify(padding, 2)
    n, c, oh, ow = x.shape
    if output_size is not None:
        h, w = (int(v) for v in output_size[-2:])
    else:
        h, w = (oh - 1) * sh - 2 * ph + kh, (ow - 1) * sw - 2 * pw + kw
    # indices count from the end when negative and drop outside the map,
    # as in the reference's scatter
    idx = indices.reshape(n, c, -1).long()
    idx = torch.where(idx < 0, idx + h * w, idx)
    ok = (idx >= 0) & (idx < h * w)
    idx = torch.where(ok, idx, 0)
    pos = torch.where(ok, torch.arange(idx.shape[-1], device=x.device), -1)
    last = torch.full((n, c, h * w), -1, dtype=torch.long,
                      device=x.device).scatter_reduce(2, idx, pos, "amax")
    won = ok & (last.gather(2, idx) == pos)
    vals = torch.where(won, x.reshape(n, c, -1), 0.0)
    return x.new_zeros(n, c, h * w).scatter_add(2, idx, vals).reshape(
        n, c, h, w)


@amp_op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, data_format == "NLC",
                 "avg", ceil_mode, exclusive)


def _no_divisor_override(fn, divisor_override):
    if divisor_override is not None:
        raise NotImplementedError(
            f"{fn}(divisor_override=...): the reference ignores it, the "
            "port does not pool by another divisor without it")


@amp_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _no_divisor_override("avg_pool2d", divisor_override)
    return _pool(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                 "avg", ceil_mode, exclusive)


@amp_op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    _no_divisor_override("avg_pool3d", divisor_override)
    return _pool(x, kernel_size, stride, padding, 3, data_format == "NDHWC",
                 "avg", ceil_mode, exclusive)


def _adaptive_pool(x, output_size, n, mode, channel_last):
    """Mean or max over adaptive bins, one spatial dim after the other
    (reference ``:231-262``); an output size of None keeps that dim."""
    out_sizes = (_tuplify(output_size, n) if not isinstance(
        output_size, (list, tuple)) else tuple(output_size))
    start = 1 if channel_last else 2
    out = x
    for d, o in enumerate(out_sizes):
        axis = start + d
        size = x.shape[axis]
        o = size if o is None else int(o)
        if size % o == 0:
            r = out.unflatten(axis, (o, size // o))
            out = r.amax(axis + 1) if mode == "max" else r.mean(axis + 1)
        else:
            bins = [out.narrow(axis, (i * size) // o,
                               -(-((i + 1) * size) // o) - (i * size) // o)
                    for i in range(o)]
            out = torch.cat([b.amax(axis, keepdim=True) if mode == "max"
                             else b.mean(axis, keepdim=True) for b in bins],
                            dim=axis)
    return out


@amp_op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "avg", False)


@amp_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, "avg", data_format == "NHWC")


@amp_op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, "avg", data_format == "NDHWC")


@amp_op("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if not return_mask:
        return _adaptive_pool(x, output_size, 1, "max", False)
    size = int(x.shape[-1])
    o = output_size if isinstance(output_size, int) else output_size[0]
    if size % o:
        raise NotImplementedError(
            "adaptive_max_pool1d(return_mask=True) needs input length "
            "divisible by output_size (uniform windows)")
    out, mask = _max_pool2d_with_mask(x.unsqueeze(-1), (size // o, 1),
                                      (size // o, 1), [(0, 0), (0, 0)])
    return out.squeeze(-1), mask.squeeze(-1)


@amp_op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if not return_mask:
        return _adaptive_pool(x, output_size, 2, "max", False)
    h, w = int(x.shape[-2]), int(x.shape[-1])
    if isinstance(output_size, (list, tuple)):
        oh = h if output_size[0] is None else int(output_size[0])
        ow = w if output_size[1] is None else int(output_size[1])
    else:
        oh = ow = int(output_size)
    if h % oh or w % ow:
        raise NotImplementedError(
            "adaptive_max_pool2d(return_mask=True) needs input dims "
            "divisible by output_size (uniform windows)")
    return _max_pool2d_with_mask(x, (h // oh, w // ow), (h // oh, w // ow),
                                 [(0, 0), (0, 0)])


@amp_op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError(
            "adaptive_max_pool3d(return_mask=True) is not implemented")
    return _adaptive_pool(x, output_size, 3, "max", False)
