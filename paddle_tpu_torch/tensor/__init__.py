"""paddle_tpu_torch.tensor — the tensor function library (port of
paddle_tpu/tensor/__init__.py: ``creation``, ``math``, ``linalg``,
``logic``, ``manipulation``, ``random``, ``search``, ``sequence`` and
``stat``, with the package's own ``einsum``, ``histogramdd``, ``add_n``
and ``sum_arrays``).

The modules are re-exported with the reference's precedence
(``:15-25``): where a name sits in two modules the same one wins, so
``mean`` is ``stat.mean``, ``mode`` is ``search.mode`` (``linalg.mode``
raises), ``numel`` is ``creation.numel`` and ``index_select`` /
``index_sample`` are ``search``'s.  ``Tensor`` is ``torch.Tensor`` and
``convert_dtype`` the port's one dtype map.  The reference's ``apply``
and ``apply1`` are left out: they record an op on its own eager tape
(``core.py``), which torch's autograd replaces.

Every function takes and returns ``torch.Tensor``s and computes on its
inputs' device.  ``torch.Tensor`` is not patched: the reference patches
its own ``Tensor`` class with these functions as methods
(``:52-183``), which here would change every PyTorch caller in the
process; call ``paddle_tpu_torch.<name>(x, ...)`` instead.
"""
from __future__ import annotations

import builtins

import torch

from paddle_tpu_torch.framework.dtype import convert_dtype
from paddle_tpu_torch.tensor import (creation, linalg, logic, manipulation,
                                     math, random, search, sequence, stat)
from paddle_tpu_torch.tensor._common import inexact, promote
from paddle_tpu_torch.tensor.creation import *  # noqa: F401,F403
from paddle_tpu_torch.tensor.linalg import *  # noqa: F401,F403
from paddle_tpu_torch.tensor.logic import *  # noqa: F401,F403
from paddle_tpu_torch.tensor.manipulation import *  # noqa: F401,F403
from paddle_tpu_torch.tensor.math import *  # noqa: F401,F403
from paddle_tpu_torch.tensor.random import *  # noqa: F401,F403
from paddle_tpu_torch.tensor.search import *  # noqa: F401,F403
from paddle_tpu_torch.tensor.sequence import *  # noqa: F401,F403
from paddle_tpu_torch.tensor.stat import (mean, std, var, median,  # noqa: F401
                                          nanmedian, quantile, nanquantile)

Tensor = torch.Tensor

__all__ = list(dict.fromkeys(
    creation.__all__ + linalg.__all__ + logic.__all__
    + manipulation.__all__ + math.__all__ + random.__all__ + search.__all__
    + sequence.__all__ + stat.__all__
    + ["Tensor", "convert_dtype", "einsum", "histogramdd", "add_n",
       "sum_arrays"]))


def einsum(equation, *operands):
    """``torch.einsum`` of the operands after the reference's
    promotion."""
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    _, _, ops = promote(*operands)
    return torch.einsum(equation, *ops)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """jnp.histogramdd of the (N, D) sample x: (counts, list of D edge
    tensors).  ``bins`` is a count or a list (of counts or edge tensors)
    for each dimension; ``ranges`` a list of (lo, hi) or None each (the
    data's range).  Counts are int64 without ``weights`` and not
    ``density``, else x's float dtype.  All on the device."""
    from paddle_tpu_torch.tensor.linalg import _bin_index, _edges
    a = x.detach().to(inexact(x.dtype))
    w = None if weights is None else weights.detach().to(
        torch.promote_types(a.dtype, inexact(weights.dtype)))
    if w is not None:
        a = a.to(w.dtype)
    n, d = a.shape
    per_dim = list(bins) if isinstance(bins, (list, tuple)) else [bins] * d
    edges, flat = [], torch.zeros(n, dtype=torch.int64, device=a.device)
    for i in range(d):
        col = a[:, i].contiguous()
        b = per_dim[i]
        if isinstance(b, int):
            lo, hi = (col.min(), col.max()) if ranges is None or \
                ranges[i] is None else ranges[i]
            e = _edges(col, b, lo, hi)
        else:
            e = torch.as_tensor(b, device=a.device).to(a.dtype)
        edges.append(e)
        flat = flat * (e.shape[0] + 1) + _bin_index(col, e)
    nbins = [e.shape[0] + 1 for e in edges]
    size = 1
    for k in nbins:
        size *= k
    src = torch.ones(n, dtype=torch.int64, device=a.device) if w is None \
        else w
    hist = torch.zeros(size, dtype=src.dtype, device=a.device)
    hist.index_add_(0, flat, src)
    hist = hist.reshape(nbins)[(builtins.slice(1, -1),) * d]
    if density:
        hist = hist.to(a.dtype)
        hist = hist / hist.sum()
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            hist = hist / (e[1:] - e[:-1]).reshape(shape)
    return hist, edges


def sum_arrays(arrs):
    """The left fold ``((a0 + a1) + a2) + ...`` of the reference."""
    out = arrs[0]
    for a in arrs[1:]:
        out = math.add(out, a)
    return out


def add_n(inputs, name=None):
    """The sum of a list of tensors; a single tensor passes through."""
    if isinstance(inputs, torch.Tensor):
        return inputs
    return sum_arrays(list(inputs))
