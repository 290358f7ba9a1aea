"""Gathers by index (port of paddle_tpu/tensor/manipulation.py's
``gather`` :231 and ``index_sample`` :304; the rest of the module is
still to port).

Both read the indices as the reference's ``jnp.take`` /
``jnp.take_along_axis`` do: a negative index counts from the end, and an
index outside ``[-n, n)`` gives the fill value (NaN for floats, the
smallest integer for signed integers, the largest for unsigned ones,
True for bool) where PyTorch's indexing would raise or fault.  The
gradient reaches x at the indices read and sums over repeats.
"""
from __future__ import annotations

import torch

__all__ = ["gather", "index_sample"]


def _fill(dtype):
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _wrapped(index, n):
    """(indices in range, valid mask): negatives counted from n."""
    index = index.long()
    index = torch.where(index < 0, index + n, index)
    valid = (index >= 0) & (index < n)
    return torch.where(valid, index, torch.zeros_like(index)), valid


def gather(x, index, axis=0, name=None):
    """The slices of ``x`` along ``axis`` at ``index`` (``jnp.take``:
    the index's shape takes the axis's place)."""
    axis = int(axis.item() if isinstance(axis, torch.Tensor) else axis)
    axis %= x.ndim
    idx, valid = _wrapped(index.reshape(-1), x.shape[axis])
    head, tail = x.shape[:axis], x.shape[axis + 1:]
    out = x.index_select(axis, idx).reshape(*head, *index.shape, *tail)
    valid = valid.reshape(*([1] * len(head)), *index.shape,
                          *([1] * len(tail)))
    return torch.where(valid, out, torch.full((), _fill(x.dtype),
                                              dtype=x.dtype,
                                              device=x.device))


def index_sample(x, index, name=None):
    """``out[i, j] = x[i, index[i, j]]`` for a 2-D x."""
    idx, valid = _wrapped(index, x.shape[1])
    out = x.gather(1, idx)
    return torch.where(valid, out, torch.full((), _fill(x.dtype),
                                              dtype=x.dtype,
                                              device=x.device))
