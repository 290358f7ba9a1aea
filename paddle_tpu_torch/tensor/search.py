"""Sorting and searching (port of paddle_tpu/tensor/search.py).

Every order is the reference's, so ties come out as they do there:

- ``argsort`` / ``sort`` sort stably ascending and flip the result for
  ``descending=True`` (``:40-56``): among ties the last index comes
  first (``torch.argsort(descending=True, stable=True)`` puts the first
  first);
- ``topk`` is ``lax.top_k``: among ties the lower index first, for
  ``largest=False`` too (``:78-80``).  It is built on the stable sort,
  since ``torch.topk`` promises no order among ties on CUDA;
- ``kthvalue`` indexes the stable ascending sort (``:118-130``);
- ``mode``: among the most frequent values the smallest, and the last
  position that holds it (``:133-152``), computed on the device for all
  rows at once (the reference loops over rows on the host).

Host reads: ``nonzero``, ``masked_select`` and ``where(cond)`` read the
count of their output's rows; ``topk`` reads a tensor ``k``.  The
integer outputs take no gradient.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.tensor import manipulation
from paddle_tpu_torch.tensor._common import promote

__all__ = [
    "argmax", "argmin", "argsort", "sort", "searchsorted", "topk", "where",
    "index_select", "nonzero", "masked_select", "kthvalue", "mode",
    "index_sample",
]


def _ordered(x):
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _arg_extreme(tfn, x, axis, keepdim):
    x = _ordered(x)
    if axis is None:
        return tfn(x)
    return tfn(x, dim=int(axis), keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """int64 index of the first maximum (of x flattened for None)."""
    return _arg_extreme(torch.argmax, x, axis, keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    """int64 index of the first minimum (of x flattened for None)."""
    return _arg_extreme(torch.argmin, x, axis, keepdim)


def _sorted(x, axis, descending):
    values, idx = torch.sort(x, dim=axis, stable=True)
    if descending:
        values, idx = values.flip(axis), idx.flip(axis)
    return values, idx


def argsort(x, axis=-1, descending=False, name=None):
    """Stable ascending order, flipped for ``descending``."""
    return _sorted(x.detach(), axis, descending)[1]


def sort(x, axis=-1, descending=False, name=None):
    """Stable ascending sort, flipped for ``descending``."""
    return _sorted(x, axis, descending)[0]


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    """Insertion indices of ``values`` in ``sorted_sequence`` (int64, or
    int32 with ``out_int32``); a sequence of more than one dimension is
    searched row by row."""
    _, _, (seq, v) = promote(sorted_sequence, values)
    return torch.searchsorted(seq.detach(), v.detach(), right=right,
                              out_int32=out_int32)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the k largest (smallest) entries along
    ``axis`` (the last for None), ordered, among ties the lower index
    first.  A tensor ``k`` is read to the host."""
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    ax = -1 if axis is None else axis
    values, idx = torch.sort(x, dim=ax, descending=largest, stable=True)
    # copies, so the full sort's buffers are freed
    return (values.narrow(ax, 0, k).contiguous(),
            idx.narrow(ax, 0, k).contiguous())


def where(condition, x=None, y=None, name=None):
    """x where ``condition``, else y, after the reference's promotion;
    ``where(condition)`` alone is :func:`nonzero` (a host read)."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    _, _, (a, b) = promote(x, y, device=condition.device)
    return torch.where(condition.bool(), a, b)


def index_select(x, index, axis=0, name=None):
    return manipulation.gather(x, index, axis=axis)


def index_sample(x, index, name=None):
    return manipulation.index_sample(x, index)


def nonzero(x, as_tuple=False):
    """int64 coordinates of the nonzero entries, (count, ndim), or a
    tuple of ndim vectors.  Reads the count back from the device."""
    if as_tuple:
        return torch.nonzero(x, as_tuple=True)
    return torch.nonzero(x)


def masked_select(x, mask, name=None):
    """The entries of x where ``mask`` (broadcast to x) is set, in
    order.  Reads their count back from the device."""
    return x[mask.bool().broadcast_to(x.shape)]


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """(the k-th smallest value, its int64 index in the stable sort)."""
    values, idx = torch.sort(x, dim=axis, stable=True)
    v, i = (values.select(axis, k - 1).contiguous(),
            idx.select(axis, k - 1).contiguous())
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i


def mode(x, axis=-1, keepdim=False, name=None):
    """(most frequent value, int64 index) along ``axis``: among values
    equally frequent the smallest, at the last position that holds it.
    One stable sort of every row on the device: run lengths of the
    sorted row, the first value whose run reaches the longest, and the
    last position of that value in the row."""
    axis = axis % x.ndim
    rows = x.movedim(axis, -1)
    s = torch.sort(rows.detach(), dim=-1, stable=True).values
    n = s.shape[-1]
    iota = torch.arange(n, device=x.device).expand_as(s)
    new_run = torch.ones_like(s, dtype=torch.bool)
    new_run[..., 1:] = s[..., 1:] != s[..., :-1]
    start = torch.cummax(torch.where(new_run, iota, torch.zeros_like(iota)),
                         -1).values
    run = iota - start + 1
    longest = run.amax(-1, keepdim=True)
    first = torch.argmax((run == longest).to(torch.uint8), -1, keepdim=True)
    value = s.gather(-1, first)
    idx = torch.where(rows.detach() == value, iota,
                      torch.full_like(iota, -1)).amax(-1, keepdim=True)
    v, i = rows.gather(-1, idx), idx
    if keepdim:
        return v.movedim(-1, axis), i.movedim(-1, axis)
    return v.squeeze(-1), i.squeeze(-1)
