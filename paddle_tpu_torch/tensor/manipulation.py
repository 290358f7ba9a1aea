"""Shape, layout and index manipulation (port of
paddle_tpu/tensor/manipulation.py).

Indices out of range behave as the reference's three JAX idioms do, where
PyTorch's indexing would raise or fault the card with a device-side
assert; every index is masked or clamped before it is used:

- **clamp**: a gather through ``__getitem__`` (``gather_nd``): a negative
  index counts from the end, then the index is clamped into the axis;
- **fill**: ``jnp.take`` / ``jnp.take_along_axis`` (``gather``,
  ``index_select``, ``index_sample``, ``take_along_axis``): a negative
  index counts from the end, and one still outside ``[0, n)`` gives the
  fill value (NaN for floats, the smallest integer for signed integers,
  the largest for unsigned ones, True for bool);
- **drop**: every ``.at[...]`` update (``put_along_axis``, ``scatter``,
  ``scatter_nd_add``, ``scatter_nd``, ``index_add``): a negative index
  counts from the end, and an update still outside is dropped.

Where an overwriting scatter meets duplicate indices, the last update in
index order wins, as on the reference's CPU, on the card too: each
target keeps its last update before the one write.  The accumulating
scatters add with atomics on the card, so their float sums agree with the
CPU's to rounding, not bitwise.  Gradients are the reference's: an
overwritten value and a dropped or losing update take none, and index
outputs take none.

``unique``, ``unique_consecutive`` and ``repeat_interleave`` with a
tensor of repeats read their output's size back from the device; no
other function does, beside reading a shape, axis or section list given
as a tensor, as the reference does.  ``pad`` and ``one_hot`` are
``nn.functional``'s, as in the reference (``one_hot`` gives float32,
where the reference's ``jax.nn.one_hot`` gives float64 with 64-bit types
on).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.dtype import convert_dtype
from paddle_tpu_torch.nn.functional.common import one_hot, pad
from paddle_tpu_torch.tensor._common import promote

__all__ = [
    "reshape", "reshape_", "flatten", "transpose", "moveaxis", "swapaxes",
    "t", "concat", "stack", "unstack", "split", "chunk", "squeeze",
    "squeeze_", "unsqueeze", "unsqueeze_", "tile", "expand", "expand_as",
    "broadcast_to", "broadcast_tensors", "flip", "rot90", "roll", "gather",
    "gather_nd", "take_along_axis", "put_along_axis", "scatter",
    "scatter_nd_add", "scatter_nd", "index_select", "index_sample",
    "index_add", "slice", "strided_slice", "crop", "pad", "cast", "unique",
    "unique_consecutive", "repeat_interleave", "as_complex", "as_real",
    "real", "imag", "tensordot", "unbind", "tril_indices", "triu_indices",
    "one_hot", "shard_index",
]


def _int_list(v):
    if isinstance(v, torch.Tensor):
        return [int(i) for i in v.reshape(-1).tolist()]
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(i.item()) if isinstance(i, torch.Tensor) else int(i)
            for i in v]


def _int(v) -> int:
    return int(v.item() if isinstance(v, torch.Tensor) else v)


def _fill(dtype):
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _wrapped(index, n):
    """(indices in range, valid mask): negatives counted from n, the
    invalid ones replaced by 0."""
    index = index.long()
    index = torch.where(index < 0, index + n, index)
    valid = (index >= 0) & (index < n)
    return torch.where(valid, index, torch.zeros_like(index)), valid


def _filled(out, valid):
    return torch.where(valid, out, torch.full((), _fill(out.dtype),
                                              dtype=out.dtype,
                                              device=out.device))


def _scatter_rows(target, pos, valid, values, mode):
    """``target`` (N, R) with the rows ``values`` (M, R) written at the
    positions ``pos`` (M,) where ``valid``: ``"set"`` (the last of
    duplicate positions wins), ``"add"`` or ``"mul"``.  Invalid and losing
    updates go to a scratch row past N, which is cut off."""
    n, r = target.shape
    pos = torch.where(valid, pos, torch.full_like(pos, n))
    if mode == "set":
        order = torch.arange(pos.shape[0], device=pos.device)
        last = torch.full((n + 1,), -1, dtype=torch.long,
                          device=pos.device).scatter_reduce(
            0, pos, order, "amax")
        pos = torch.where(valid & (last[pos] == order), pos,
                          torch.full_like(pos, n))
    scratch = (target.new_ones if mode == "mul" else target.new_zeros)((1, r))
    padded = torch.cat([target, scratch])
    if mode == "set":
        out = padded.index_put((pos,), values)
    elif mode == "add":
        out = padded.index_add(0, pos, values)
    else:
        out = padded.scatter_reduce(0, pos[:, None].expand(-1, r), values,
                                    "prod")
    return out[:n]


# -- shapes ------------------------------------------------------------------

def reshape(x, shape, name=None):
    return x.reshape(_int_list(shape))


def reshape_(x, shape, name=None):
    """Reshape ``x`` itself and return it (reference ``:44-47``: the data
    changes outside autograd)."""
    x.data = x.data.reshape(_int_list(shape))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return x.reshape(tuple(x.shape[:s]) + (-1,) + tuple(x.shape[e + 1:]))


def transpose(x, perm, name=None):
    return x.permute(_int_list(perm))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(x, axis1, axis2)


def t(x, name=None):
    """The transpose of a matrix; every axis reversed past 2-D (``a.T``);
    below 2-D, x itself."""
    if x.ndim < 2:
        return x
    return x.permute(*reversed(range(x.ndim)))


def concat(x, axis=0, name=None):
    """``jnp.concatenate``: the tensors promoted to their common dtype."""
    _, _, ts = promote(*list(x))
    return torch.cat(ts, dim=_int(axis))


def stack(x, axis=0, name=None):
    _, _, ts = promote(*list(x))
    return torch.stack(ts, dim=_int(axis))


def unstack(x, axis=0, num=None, name=None):
    """The first ``num`` (every one without it) slices along ``axis``."""
    n = num if num is not None else x.shape[axis]
    parts = list(torch.movedim(x, axis, 0).unbind(0))
    if n > len(parts):
        raise IndexError(f"unstack: num={n} past the axis's {len(parts)}")
    return parts[:n]


def unbind(input, axis=0):
    return unstack(input, axis=axis)


def split(x, num_or_sections, axis=0, name=None):
    """Equal parts for an int (the axis must divide), else the listed
    sizes, one of which may be -1 for the rest."""
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: axis {axis} size {dim} is not divisible by "
                f"num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = _int_list(num_or_sections)
        if any(s < 0 for s in sizes):
            known = builtins.sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else dim - known for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def squeeze(x, axis=None, name=None):
    """Drop the axes of size 1 among ``axis`` (every one for None)."""
    if axis is None:
        return x.reshape([s for s in x.shape if s != 1])
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    drop = {a % x.ndim for a in _int_list(axes) if x.shape[a % x.ndim] == 1}
    return x.reshape([s for i, s in enumerate(x.shape) if i not in drop])


squeeze_ = squeeze


def unsqueeze(x, axis, name=None):
    """Insert axes of size 1, one after another, each at its place in the
    tensor it is inserted into."""
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    out = x
    for ax in _int_list(axes):
        out = out.unsqueeze(ax)
    return out


unsqueeze_ = unsqueeze


def tile(x, repeat_times, name=None):
    return torch.tile(x, _int_list(repeat_times))


def expand(x, shape, name=None):
    """Broadcast to ``shape``; -1 keeps the matching axis of x."""
    tgt = _int_list(shape)
    off = len(tgt) - x.ndim
    tgt = [x.shape[i - off] if s == -1 else s for i, s in enumerate(tgt)]
    return torch.broadcast_to(x, tgt)


def expand_as(x, y, name=None):
    return torch.broadcast_to(x, tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis, name=None):
    return torch.flip(x, _int_list(axis if isinstance(axis, (list, tuple))
                                   else [axis]))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


def roll(x, shifts, axis=None, name=None):
    return torch.roll(x, shifts, axis)


# -- gathers ------------------------------------------------------------------

def gather(x, index, axis=0, name=None):
    """The slices of ``x`` along ``axis`` at ``index`` (``jnp.take``:
    the index's shape takes the axis's place; fill past the axis)."""
    axis = _int(axis) % x.ndim
    idx, valid = _wrapped(index.reshape(-1), x.shape[axis])
    head, tail = x.shape[:axis], x.shape[axis + 1:]
    out = x.index_select(axis, idx).reshape(*head, *index.shape, *tail)
    valid = valid.reshape(*([1] * len(head)), *index.shape,
                          *([1] * len(tail)))
    return _filled(out, valid)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis=axis)


def index_sample(x, index, name=None):
    """``out[i, j] = x[i, index[i, j]]`` for a 2-D x (fill past a row)."""
    idx, valid = _wrapped(index, x.shape[1])
    return _filled(x.gather(1, idx), valid)


def gather_nd(x, index, name=None):
    """``x[index[..., 0], ..., index[..., k - 1]]`` with the first k axes
    indexed: each index counted from the end if negative, then clamped.
    As XLA's gather and its transpose do, a clamped index reads the edge
    but passes it no gradient."""
    idx = index.long()
    comps, valid = [], torch.ones((), dtype=torch.bool, device=x.device)
    for j in range(idx.shape[-1]):
        n = x.shape[j]
        c = idx[..., j]
        c = torch.where(c < 0, c + n, c)
        valid = valid & (c >= 0) & (c < n)
        comps.append(c.clamp(0, n - 1))
    out = x[tuple(comps)]
    valid = valid.reshape(tuple(valid.shape) + (1,) * (out.ndim - valid.ndim))
    return torch.where(valid, out, out.detach())


def take_along_axis(arr, indices, axis, name=None):
    """``jnp.take_along_axis``: the axes other than ``axis`` broadcast;
    fill past the axis."""
    axis %= arr.ndim
    idx, valid = _wrapped(indices, arr.shape[axis])
    a_shape, i_shape = list(arr.shape), list(idx.shape)
    a_shape[axis] = i_shape[axis] = 1
    shape = list(torch.broadcast_shapes(tuple(a_shape), tuple(i_shape)))
    a_full, i_full = list(shape), list(shape)
    a_full[axis], i_full[axis] = arr.shape[axis], idx.shape[axis]
    out = arr.expand(a_full).gather(axis, idx.expand(i_full))
    return _filled(out, valid.expand(i_full))


# -- scatters -----------------------------------------------------------------

def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """``arr.at[...]`` of ``jnp.put_along_axis``: ``values`` broadcast to
    ``indices``' shape and written (``"assign"``, the last duplicate
    winning), added (``"add"``) or multiplied (``"mul"`` /
    ``"multiply"``) at ``indices`` along ``axis`` and at their own
    position along the other axes; updates past an axis are dropped."""
    modes = {"assign": "set", "add": "add", "mul": "mul", "multiply": "mul"}
    if reduce not in modes:
        raise ValueError(f"unknown reduce {reduce}")
    axis %= arr.ndim
    idx = indices.long()
    v = torch.broadcast_to(torch.as_tensor(values, device=arr.device),
                           idx.shape).to(arr.dtype)
    lin = torch.zeros((), dtype=torch.long, device=arr.device)
    valid = torch.ones((), dtype=torch.bool, device=arr.device)
    for d in range(arr.ndim):
        n = arr.shape[d]
        if d == axis:
            comp = torch.where(idx < 0, idx + n, idx)
        else:
            view = [1] * idx.ndim
            view[d] = -1
            comp = torch.arange(idx.shape[d],
                                device=arr.device).reshape(view)
        valid = valid & (comp >= 0) & (comp < n)
        lin = lin * n + comp
    lin, valid = torch.broadcast_tensors(lin, valid)
    out = _scatter_rows(arr.reshape(-1, 1), lin.reshape(-1),
                        valid.reshape(-1), v.reshape(-1, 1), modes[reduce])
    return out.reshape(arr.shape)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of ``x`` at ``index`` replaced by ``updates`` (the last of
    duplicate indices winning), or with ``overwrite=False`` first zeroed,
    then the sum of their updates (reference ``:270-281``)."""
    n = x.shape[0]
    idx, valid = _wrapped(index.reshape(-1), n)
    upd = torch.broadcast_to(torch.as_tensor(updates, device=x.device),
                             (idx.shape[0],) + tuple(x.shape[1:]))
    u2 = upd.to(x.dtype).reshape(idx.shape[0], -1)
    x2 = x.reshape(n, -1)
    if overwrite:
        out = _scatter_rows(x2, idx, valid, u2, "set")
    else:
        out = _scatter_rows(_scatter_rows(x2, idx, valid,
                                          torch.zeros_like(u2), "set"),
                            idx, valid, u2, "add")
    return out.reshape(x.shape)


def _nd_rows(x, index):
    """(row of x's first k axes flattened, valid) of each index vector
    (index (..., k))."""
    idx = index.long()
    lin = torch.zeros(idx.shape[:-1], dtype=torch.long, device=x.device)
    valid = torch.ones(idx.shape[:-1], dtype=torch.bool, device=x.device)
    for j in range(idx.shape[-1]):
        c, ok = _wrapped(idx[..., j], x.shape[j])
        lin = lin * x.shape[j] + c
        valid = valid & ok
    return lin.reshape(-1), valid.reshape(-1)


def scatter_nd_add(x, index, updates, name=None):
    """``x.at[index[..., 0], ..., index[..., k - 1]].add(updates)``."""
    k = index.shape[-1]
    lin, valid = _nd_rows(x, index)
    rows = int(np.prod(x.shape[:k], dtype=np.int64))
    upd = torch.broadcast_to(updates, tuple(index.shape[:-1])
                             + tuple(x.shape[k:]))
    out = _scatter_rows(x.reshape(rows, -1), lin, valid,
                        upd.to(x.dtype).reshape(lin.shape[0], -1), "add")
    return out.reshape(x.shape)


def scatter_nd(index, updates, shape, name=None):
    """``scatter_nd_add`` into zeros of ``shape`` and updates' dtype."""
    z = torch.zeros(_int_list(shape), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(z, index, updates)


def index_add(x, index, axis, value, name=None):
    """``value``'s slices along ``axis`` added at ``index``."""
    axis %= x.ndim
    xm = torch.movedim(x, axis, 0)
    vm = torch.movedim(value, axis, 0)
    idx, valid = _wrapped(index.reshape(-1), xm.shape[0])
    vm = torch.broadcast_to(vm, (idx.shape[0],) + tuple(xm.shape[1:]))
    out = _scatter_rows(xm.reshape(xm.shape[0], -1), idx, valid,
                        vm.to(x.dtype).reshape(idx.shape[0], -1), "add")
    return torch.movedim(out.reshape(xm.shape), 0, axis)


# -- slices -------------------------------------------------------------------

def slice(input, axes, starts, ends, name=None):
    """``input[starts:ends]`` along each of ``axes``, the ends clamped
    into the axis (a negative one counted from its end)."""
    idx = [builtins.slice(None)] * input.ndim
    for ax, s, e in zip(_int_list(axes), _int_list(starts),
                        _int_list(ends)):
        dim = input.shape[ax]
        s2 = builtins.max(s + dim, 0) if s < 0 else builtins.min(s, dim)
        e2 = builtins.max(e + dim, 0) if e < 0 else builtins.min(e, dim)
        idx[ax] = builtins.slice(s2, e2)
    return input[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python's ``slice(start, end, stride)`` along each axis; a negative
    stride walks backwards."""
    out = x
    for ax, s, e, st in zip(_int_list(axes), _int_list(starts),
                            _int_list(ends), _int_list(strides)):
        lo, hi, step = builtins.slice(s, e, st).indices(out.shape[ax])
        if step > 0:
            idx = [builtins.slice(None)] * out.ndim
            idx[ax] = builtins.slice(lo, hi, step)
            out = out[tuple(idx)]
        else:
            out = out.index_select(ax, torch.arange(lo, hi, step,
                                                    device=out.device))
    return out


def crop(x, shape=None, offsets=None, name=None):
    """The block of ``shape`` (-1: to the end) at ``offsets`` (zeros)."""
    shape = _int_list(shape)
    offsets = _int_list(offsets) if offsets is not None else [0] * len(shape)
    idx = tuple(builtins.slice(o, o + (s if s != -1 else x.shape[i] - o))
                for i, (o, s) in enumerate(zip(offsets, shape)))
    return x[idx]


# -- dtypes -------------------------------------------------------------------

def cast(x, dtype):
    """x in ``dtype``.  A float cast to an integer type truncates toward
    0 and saturates as XLA does: NaN becomes 0, values past the type's
    range its limits (PyTorch leaves those undefined)."""
    dt = convert_dtype(dtype)
    if (x.is_floating_point() and not dt.is_floating_point
            and not dt.is_complex and dt != torch.bool):
        info = torch.iinfo(dt)
        y = x.nan_to_num(0.0, posinf=0.0, neginf=0.0)
        hi = torch.full((), info.max, dtype=dt, device=x.device)
        lo = torch.full((), info.min, dtype=dt, device=x.device)
        return torch.where(x >= float(info.max), hi,
                           torch.where(x <= float(info.min), lo,
                                       y.clamp(info.min, info.max).to(dt)))
    return x.to(dt)


def as_complex(x, name=None):
    """The last axis (real, imaginary) as one complex value."""
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return torch.stack([x.real, x.imag], dim=-1)


def real(x, name=None):
    return x.real if x.is_complex() else x


def imag(x, name=None):
    return x.imag if x.is_complex() else torch.zeros_like(x)


def tensordot(x, y, axes=2, name=None):
    """``jnp.tensordot`` after the reference's promotion: ``axes`` an int
    (x's last, y's first) or a pair of axis lists (or of single axes)."""
    _, _, (a, b) = promote(x, y)
    if isinstance(axes, (list, tuple)):
        axes = [list(v) if isinstance(v, (list, tuple)) else [int(v)]
                for v in axes]
    return torch.tensordot(a, b, dims=axes)


# -- host-sized results -------------------------------------------------------

def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique``: the sorted distinct values (slices along ``axis``),
    with the index of each one's first occurrence, the inverse (x's shape
    without ``axis``, as numpy 2 gives it) and the counts, all int64.
    Without ``axis`` every NaN is one value, last, as ``jnp.unique``
    (``equal_nan``) keeps it (reference ``:379``); slices along an axis
    keep NaN rows apart, as the reference's do.  Reads the number of
    distinct values back from the device."""
    if axis is None:
        vals, inv, counts = torch.unique(x.reshape(-1), sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
        dim = 0
        if vals.is_floating_point() or vals.is_complex():
            # the sort puts the NaNs last, each a value of its own
            n_nan = int(torch.isnan(vals).sum())
            if n_nan > 1:
                m = vals.shape[0] - n_nan
                vals = vals[:m + 1]
                inv = inv.clamp_max(m)
                counts = torch.cat([counts[:m],
                                    counts[m:].sum(0, keepdim=True)])
    else:
        dim = axis % x.ndim
        vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                         return_counts=True, dim=dim)
    outs = [vals]
    if return_index:
        n = inv.shape[0]
        first = torch.full((vals.shape[dim],), n, dtype=torch.long,
                           device=x.device)
        outs.append(first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        outs.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Each run of equal values (slices along ``axis``; the flattened x
    without one) kept once, with the flat inverse and the run lengths.
    Reads the number of runs back from the device."""
    src = x.reshape(-1) if axis is None else x
    out, inv, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True,
        dim=None if axis is None else axis % x.ndim)
    outs = [out]
    if return_inverse:
        outs.append(inv.reshape(-1))
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def repeat_interleave(x, repeats, axis=None, name=None):
    """``jnp.repeat``: each element (slice along ``axis``; of the
    flattened x without one) ``repeats`` times.  A tensor of repeats is
    summed on the device and the total read back."""
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device).long()
    return torch.repeat_interleave(x, repeats, dim=axis)


def tril_indices(row, col=None, offset=0, dtype="int64", device=None):
    """(2, n) int64 coordinates of the lower triangle below diagonal
    ``offset``, row by row."""
    col = col if col is not None else row
    return torch.tril_indices(row, col, offset,
                              device=resolve_device(device))


def triu_indices(row, col=None, offset=0, dtype="int64", device=None):
    col = col if col is not None else row
    return torch.triu_indices(row, col, offset,
                              device=resolve_device(device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """An id's place within its shard where the shard is ``shard_id``,
    else ``ignore_value`` (shards of ceil(index_num / nshards) ids)."""
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(input, size, rounding_mode="floor")
                       == shard_id, torch.remainder(input, size),
                       torch.full((), ignore_value, dtype=input.dtype,
                                  device=input.device))
