"""Ragged sequences (port of paddle_tpu/tensor/sequence.py, the
reference's replacement for LoDTensor).

Two encodings, as in the reference:

- padded-dense ``(data [B, T, ...], lengths [B])``, where every op is a
  masked dense op;
- flat-segmented ``(values [total, ...], segment_ids [total])``, for the
  segment reductions and ``embedding_bag``.

:func:`sequence_pad`, :func:`sequence_unpad` and
:func:`lengths_to_segment_ids` convert between them.

The reference's edge values hold: an empty segment's ``segment_max`` /
``segment_min`` is 0 (not -inf / +inf), ``segment_mean`` divides by
``max(n, 1)``, ``sequence_pool``'s ``max`` / ``min`` of an empty row is
0 and its ``first`` / ``last`` ``pad_value``, and ``segment_softmax``
takes 0 for a segment's max where that max is not finite.  Ties in a
max or min split the gradient evenly (``torch.amax`` and
``scatter_reduce``'s ``amax`` do; ``torch.max(dim=...)`` gives it to one
element).  Segment ids outside ``[0, num_segments)`` are dropped by the
reductions.

A function whose output size depends on the data reads that one number
back from the device: ``sequence_unpad``, ``lengths_to_segment_ids``,
``sequence_expand_as`` and ``sequence_concat`` always; ``sequence_mask``
and ``sequence_pad`` without ``maxlen``; the segment reductions without
``num_segments``.  No other function reads back.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.dtype import convert_dtype
from paddle_tpu_torch.tensor._common import result_type
# the module, not its names: manipulation imports nn.functional, which
# imports this module
from paddle_tpu_torch.tensor import manipulation

__all__ = [
    "sequence_mask", "sequence_pad", "sequence_unpad",
    "lengths_to_segment_ids", "segment_ids_to_lengths",
    "segment_sum", "segment_mean", "segment_max", "segment_min",
    "segment_softmax",
    "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_first_step", "sequence_last_step", "sequence_concat",
    "sequence_expand_as", "sequence_enumerate",
    "embedding_bag",
]


def _static_int(v, name):
    if isinstance(v, torch.Tensor):
        v = int(v.item())
    if v is None:
        raise ValueError(f"{name} must be a Python int")
    return int(v)


def _lens(lengths, device=None):
    return torch.as_tensor(lengths, device=device).long()


def _where(m, a, fill):
    """``jnp.where(m, a, fill)`` for a Python ``fill``: a's dtype unless
    the fill's kind is wider (an int tensor with a float fill: float64)."""
    dt = result_type(a, fill)
    return torch.where(m, a.to(dt), torch.full((), fill, dtype=dt,
                                               device=a.device))


# -- masks and the encodings' conversions -------------------------------------

def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` in ``dtype``; ``maxlen`` defaults to
    ``max(x)``, read back."""
    x = _lens(x)
    maxlen = int(x.max()) if maxlen is None else _static_int(maxlen,
                                                             "maxlen")
    pos = torch.arange(maxlen, device=x.device)
    return (pos < x[..., None]).to(convert_dtype(dtype))


def lengths_to_segment_ids(lengths, name=None):
    """[3, 1, 2] -> [0, 0, 0, 1, 2, 2] (int64); reads the total back."""
    lens = _lens(lengths)
    return torch.repeat_interleave(
        torch.arange(lens.shape[0], device=lens.device), lens)


def segment_ids_to_lengths(segment_ids, num_segments, name=None):
    """The count of each id in [0, num_segments) (int64)."""
    n = _static_int(num_segments, "num_segments")
    ids = _lens(segment_ids)
    return _segment_add(torch.ones_like(ids), ids, n)


def sequence_pad(x, pad_value, lengths, maxlen=None, name=None):
    """Flat values [total, ...] and lengths [B] -> (padded [B, maxlen,
    ...], lengths); steps past ``maxlen`` (the longest length, read back,
    without it) are dropped."""
    lens = _lens(lengths, x.device)
    if maxlen is None:
        maxlen = int(lens.max())
    maxlen = _static_int(maxlen, "maxlen")
    b, total = lens.shape[0], x.shape[0]
    ends = torch.cumsum(lens, 0)
    i = torch.arange(total, device=x.device)
    seg = torch.searchsorted(ends, i, right=True).clamp_max(b - 1)
    pos = i - (ends - lens)[seg]
    valid = (pos >= 0) & (pos < maxlen)
    lin = torch.where(valid, seg * maxlen + pos,
                      torch.full_like(pos, b * maxlen))
    rest = tuple(x.shape[1:])
    out = torch.full((b * maxlen + 1,) + rest, pad_value, dtype=x.dtype,
                     device=x.device)
    out = out.index_put((lin,), x)
    return out[:b * maxlen].reshape((b, maxlen) + rest), lengths


def sequence_unpad(x, length, name=None):
    """Padded [B, T, ...] and lengths [B] -> flat [total, ...]; reads
    the total back."""
    lens = _lens(length, x.device)
    total = int(lens.sum())
    seg = torch.repeat_interleave(torch.arange(lens.shape[0],
                                               device=x.device),
                                  lens, output_size=total)
    pos = torch.arange(total, device=x.device) - (torch.cumsum(lens, 0)
                                                  - lens)[seg]
    return x[seg, pos.clamp_max(x.shape[1] - 1)]


# -- segment reductions (flat-segmented) --------------------------------------

def _num_segments(segment_ids, num_segments):
    if num_segments is not None:
        return _static_int(num_segments, "num_segments")
    return int(_lens(segment_ids).max()) + 1


def _valid_ids(ids, n):
    ids = ids.long()
    valid = (ids >= 0) & (ids < n)
    return torch.where(valid, ids, torch.full_like(ids, n)), valid


def _segment_add(data, ids, n):
    ids, _ = _valid_ids(ids, n)
    out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, data)[:n]


def _segment_extreme(data, ids, n, kind):
    """max / min a segment, 0 where the segment is empty (the scratch
    base takes no part: ``include_self=False``)."""
    ids, _ = _valid_ids(ids, n)
    out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    idx = ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand(data.shape)
    return out.scatter_reduce(0, idx, data, kind, include_self=False)[:n]


def _counts(ids, n, dtype):
    return _segment_add(torch.ones(ids.shape[0], dtype=dtype,
                                   device=ids.device), ids, n)


def segment_sum(data, segment_ids, num_segments=None, name=None):
    """The sum of each segment's rows (0 for an empty one)."""
    n = _num_segments(segment_ids, num_segments)
    return _segment_add(data, _lens(segment_ids, data.device), n)


def segment_mean(data, segment_ids, num_segments=None, name=None):
    """The mean of each segment's rows: the sum over max(count, 1); an
    integer ``data`` gives float64."""
    n = _num_segments(segment_ids, num_segments)
    ids = _lens(segment_ids, data.device)
    s = _segment_add(data, ids, n)
    dt = result_type(data, 1.0)
    cnt = _counts(ids, n, data.dtype).to(dt).clamp_min(1.0)
    return s.to(dt) / cnt.reshape((n,) + (1,) * (data.ndim - 1))


def segment_max(data, segment_ids, num_segments=None, name=None):
    n = _num_segments(segment_ids, num_segments)
    return _segment_extreme(data, _lens(segment_ids, data.device), n, "amax")


def segment_min(data, segment_ids, num_segments=None, name=None):
    n = _num_segments(segment_ids, num_segments)
    return _segment_extreme(data, _lens(segment_ids, data.device), n, "amin")


def _take_clamped(t, ids):
    """``t[ids]`` as jnp indexes: negatives counted from the end, then
    clamped."""
    n = t.shape[0]
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return t[ids]


def segment_softmax(data, segment_ids, num_segments=None, name=None):
    """Softmax within each segment of a flat tensor; a segment's max that
    is not finite counts as 0."""
    n = _num_segments(segment_ids, num_segments)
    ids = _lens(segment_ids, data.device)
    mx = _segment_extreme(data, ids, n, "amax")
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(data - _take_clamped(mx, ids))
    z = _segment_add(e, ids, n)
    return e / _take_clamped(z, ids)


# -- padded-dense sequence ops ------------------------------------------------

def _time_mask(lens, t, extra_dims):
    m = torch.arange(t, device=lens.device)[None, :] < lens[:, None]
    return m.reshape(tuple(m.shape) + (1,) * extra_dims)


def sequence_pool(x, pool_type, lengths, pad_value=0.0, name=None):
    """Masked pooling over the time axis of padded [B, T, ...] input:
    ``average`` / ``mean``, ``sum``, ``sqrt`` (sum over sqrt(max(len,
    1))), ``max``, ``min``, ``first``, ``last`` (index max(len - 1, 0))."""
    pool_type = pool_type.lower()
    lens = _lens(lengths, x.device)
    extra = x.ndim - 2
    m = _time_mask(lens, x.shape[1], extra)
    empty = (lens == 0).reshape((-1,) + (1,) * extra)
    if pool_type in ("average", "mean", "sum", "sqrt"):
        s = _where(m, x, 0.0).sum(1)
        if pool_type == "sum":
            out = s
        else:
            denom = lens.clamp_min(1).to(s.dtype).reshape((-1,) +
                                                          (1,) * extra)
            out = s / (torch.sqrt(denom) if pool_type == "sqrt" else denom)
    elif pool_type in ("max", "min"):
        fill = float("-inf") if pool_type == "max" else float("inf")
        red = torch.amax if pool_type == "max" else torch.amin
        out = _where(~empty, red(_where(m, x, fill), dim=1), 0.0)
    elif pool_type == "first":
        out = x[:, 0]
    elif pool_type == "last":
        idx = (lens - 1).clamp_min(0).reshape((-1, 1) + (1,) * extra)
        out = manipulation.take_along_axis(x, idx, axis=1).squeeze(1)
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    if pool_type in ("first", "last") or pad_value:
        out = _where(~empty, out, pad_value)
    return out


def sequence_first_step(x, lengths, name=None):
    return sequence_pool(x, "first", lengths)


def sequence_last_step(x, lengths, name=None):
    return sequence_pool(x, "last", lengths)


def sequence_softmax(x, lengths, name=None):
    """Masked softmax along the time axis of padded [B, T, ...] input; an
    empty row gives zeros."""
    lens = _lens(lengths, x.device)
    m = _time_mask(lens, x.shape[1], x.ndim - 2)
    masked = _where(m, x, float("-inf"))
    z = masked - masked.amax(1, keepdim=True)
    e = _where(m, torch.exp(z), 0.0)
    return e / e.sum(1, keepdim=True).clamp_min(1e-30)


def sequence_reverse(x, lengths, name=None):
    """Each row's first lengths[i] steps reversed; the padding stays."""
    lens = _lens(lengths, x.device)[:, None]
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    return manipulation.take_along_axis(x, src.reshape(tuple(src.shape) +
                                          (1,) * (x.ndim - 2)), axis=1)


def sequence_concat(inputs, lengths_list, name=None):
    """Row i of the output is x1[i, :l1[i]] ++ x2[i, :l2[i]] ++ ...,
    padded with 0: (padded, lengths).  Reads the longest row back."""
    dev = inputs[0].device
    lens = [_lens(v, dev) for v in lengths_list]
    total = sum(lens[1:], lens[0])
    maxlen = int(total.max())
    b = inputs[0].shape[0]
    rest = tuple(inputs[0].shape[2:])
    width = maxlen + 1            # a scratch column takes the masked steps
    out = inputs[0].new_zeros((b * width,) + rest)
    offset = torch.zeros(b, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for a, n in zip(inputs, lens):
        pos = torch.arange(a.shape[1], device=dev)[None, :]
        dst = torch.where(pos < n[:, None], offset[:, None] + pos,
                          torch.full_like(pos, maxlen))
        out = out.index_put(((rows * width + dst).reshape(-1),),
                            a.to(out.dtype).reshape((-1,) + rest))
        offset = offset + n
    return out.reshape((b, width) + rest)[:, :maxlen], total


def sequence_expand_as(x, lengths, name=None):
    """Row i of x [B, ...] repeated lengths[i] times, flat; reads the
    total back."""
    return x[lengths_to_segment_ids(_lens(lengths, x.device))]


def sequence_enumerate(x, win_size, pad_value=0, lengths=None, name=None):
    """Every window of ``win_size`` ids of padded [B, T] ids -> [B, T,
    win_size]; positions past the row's length (or T) are
    ``pad_value``."""
    win_size = int(win_size)
    b, t = x.shape
    pos = (torch.arange(t, device=x.device)[None, :, None]
           + torch.arange(win_size, device=x.device)[None, None, :])
    limit = (torch.full((b, 1, 1), t, device=x.device) if lengths is None
             else _lens(lengths, x.device)[:, None, None])
    valid = pos < limit.clamp_max(t)
    got = x[:, :, None].expand(b, t, win_size).gather(
        1, pos.clamp(0, t - 1).expand(b, t, win_size))
    return torch.where(valid, got, torch.full((), pad_value, dtype=x.dtype,
                                              device=x.device))


# -- embedding-bag ------------------------------------------------------------

def embedding_bag(input, weight, lengths=None, mode="sum", padding_idx=None,
                  name=None):
    """Lookup and pooled reduction in one call (the
    fused_embedding_seq_pool role).

    Padded form: ``input`` [B, T] ids and ``lengths`` [B] (T each without
    it) -> [B, D]: steps past a length and ids equal to ``padding_idx``
    are masked out; ``max`` of a row with nothing left is 0, and ``mean``
    divides by max(count, 1).  Flat form: ``input`` [total] ids with
    ``lengths`` as their segment ids -> [num_segments, D] by
    ``segment_sum`` / ``segment_mean`` / ``segment_max`` (``padding_idx``
    is not read there, as in the reference).  An id outside the table
    looks up NaN (``jnp.take``).  The gradient reaches ``weight`` at the
    ids read."""
    mode = mode.lower()
    if mode not in ("sum", "mean", "max"):
        raise ValueError(f"embedding_bag mode must be sum/mean/max, "
                         f"got {mode!r}")
    if input.ndim == 2:
        e = manipulation.gather(weight, input, axis=0)      # [B, T, D]
        if lengths is None:
            lens = torch.full((input.shape[0],), input.shape[1],
                              dtype=torch.long, device=input.device)
        else:
            lens = _lens(lengths, input.device)
        m = _time_mask(lens, input.shape[1], 1)
        if padding_idx is not None:
            m = m & (input != padding_idx)[..., None]
        if mode == "max":
            out = _where(m, e, float("-inf")).amax(1)
            return _where(torch.isfinite(out), out, 0.0)
        s = _where(m, e, 0.0).sum(1)
        if mode == "sum":
            return s
        return s / m.to(e.dtype).sum(1).clamp_min(1.0)
    if lengths is None:
        raise ValueError("flat embedding_bag needs segment_ids in `lengths`")
    emb = manipulation.gather(weight, input, axis=0)
    red = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}[mode]
    return red(emb, lengths)
