"""Statistics (port of paddle_tpu/tensor/stat.py).

``median`` and ``quantile`` are built on the stable sort, as jnp builds
them: ``median`` averages the two middle values (``:38-41``; its
``mode`` argument is read by nothing), a slice holding a NaN gives NaN,
and the interpolation weights of ``quantile`` are formed in float64
(JAX's ``q``).  ``torch.median`` (the lower middle value) and
``torch.quantile`` (which refuses inputs above 2**24 elements) are not
used.  ``std`` / ``var`` take ``unbiased`` as ddof 1 or 0.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.tensor._common import (inexact, keepdim_shape,
                                             moved_flat, reduce_dims)
from paddle_tpu_torch.tensor.creation import numel
from paddle_tpu_torch.tensor.math import mean as _mean

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile", "numel"]


def mean(x, axis=None, keepdim=False, name=None):
    """The mean (``paddle.mean`` resolves here): of an integer x in
    float32 (int64: float64)."""
    return _mean(x, axis, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = x.to(inexact(x.dtype))
    return torch.var(x, dim=reduce_dims(axis, x.ndim),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = x.to(inexact(x.dtype))
    return torch.std(x, dim=reduce_dims(axis, x.ndim),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _sorted_rows(x, axis, squash_nans):
    """(rows sorted along the last axis, the shape kept, the reduced
    axes): the axes of ``axis`` moved last and flattened.  Without
    ``squash_nans`` a row holding a NaN becomes all NaN."""
    x = x.to(inexact(x.dtype))
    dims = reduce_dims(axis, x.ndim)
    flat, keep = moved_flat(x, dims) if x.ndim else (x.reshape(1), ())
    if not squash_nans:
        flat = torch.where(torch.isnan(flat).any(-1, keepdim=True),
                           torch.full_like(flat, float("nan")), flat)
    return torch.sort(flat, dim=-1, stable=True).values, keep, dims


def _quantile(x, q, axis, keepdim, squash_nans, midpoint=False):
    """jnp's ``_quantile``: positions ``q * (n - 1)`` in float64 (n
    counts the non-NaN values when ``squash_nans``), the values at their
    floor and ceiling linearly interpolated (averaged for
    ``midpoint``)."""
    rows, keep, dims = _sorted_rows(x, axis, squash_nans)
    dev, f64 = rows.device, torch.float64
    if isinstance(q, torch.Tensor):
        q_t = q.to(dev, f64)
    elif isinstance(q, (list, tuple)):
        q_t = torch.stack([torch.full((), float(v), dtype=f64, device=dev)
                           for v in q])
    else:
        q_t = torch.full((), float(q), dtype=f64, device=dev)
    q_1d = q_t.reshape(-1)
    q_col = q_1d.reshape(-1, *([1] * len(keep)))
    if squash_nans:
        top = (~torch.isnan(rows)).sum(-1).to(f64) - 1
        pos = q_col * top
        lo = torch.maximum(torch.zeros_like(top), torch.minimum(
            torch.floor(pos), top)).long()
        hi = torch.maximum(torch.zeros_like(top), torch.minimum(
            torch.ceil(pos), top)).long()
    else:
        pos = q_col * (rows.shape[-1] - 1)
        lo = torch.floor(pos).clamp(0, rows.shape[-1] - 1).long()
        hi = torch.ceil(pos).clamp(0, rows.shape[-1] - 1).long()
    w_hi = pos - torch.floor(pos)
    w_lo = 1 - w_hi
    src = rows.unsqueeze(0).expand(q_1d.shape[0], *rows.shape)
    lo_v, hi_v = (src.gather(-1, i.expand(q_1d.shape[0], *keep)
                             .unsqueeze(-1)).squeeze(-1) for i in (lo, hi))
    if midpoint:
        out = (lo_v + hi_v) * 0.5
    else:
        out = (lo_v.double() * w_lo + hi_v.double() * w_hi).to(rows.dtype)
    if keepdim:
        shape = keepdim_shape(x.shape, dims) if x.ndim else ()
        out = out.reshape(q_1d.shape[0], *shape)
    if q_t.ndim == 0:
        out = out[0]
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The middle value, or the mean of the two middle values, along
    ``axis`` (of every value for None); NaN where the slice holds one."""
    return _quantile(x, 0.5, axis, keepdim, False, midpoint=True)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """:func:`median` of the non-NaN values."""
    return _quantile(x, 0.5, axis, keepdim, True, midpoint=True)


def quantile(x, q, axis=None, keepdim=False, name=None):
    """The q-th quantiles by linear interpolation; a list ``q`` adds a
    leading axis.  Any size: built on ``torch.sort``."""
    return _quantile(x, q, axis, keepdim, False)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    """:func:`quantile` of the non-NaN values."""
    return _quantile(x, q, axis, keepdim, True)
