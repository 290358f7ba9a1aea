"""The common functionals (port of paddle_tpu/nn/functional/common.py):
``linear``, the dropouts, ``embedding``, ``one_hot``, ``pad``,
``interpolate``, ``unfold`` / ``fold``, ``bilinear``, the distances, the
pixel and channel shuffles and ``label_smooth``.

``interpolate`` reproduces the reference's routes (``:180-253``):

- ``nearest`` takes rows ``floor(i * in / out)`` (f32 arithmetic), sizes
  ``int(in * scale_factor)``; ``area`` is an adaptive mean where the size
  divides and that nearest take where it does not;
- ``linear``, ``bilinear``, ``trilinear`` and ``bicubic`` are
  ``jax.image.resize``: per changed dim a weight matrix of its
  scale-and-translate (the triangle kernel, or Keys' cubic at a = -0.5),
  widened by ``in / out`` when downsampling (antialiased), normalised by
  its column sums and zero where the sample falls outside the input; the
  port builds the same matrices and contracts the input with them, one
  dim after the other;
- ``align_corners=True`` samples at ``linspace(0, in - 1, out)`` by
  ``map_coordinates(order=1, mode="nearest")``, linear even for
  ``bicubic``, over every spatial dim;
- ``align_mode`` is read by nothing.

The dropouts draw from ``generator`` (the default generator of x's device
when None); only the distribution matches the reference's ``jax.random``
bits.  ``pixel_shuffle``, ``pixel_unshuffle`` and ``channel_shuffle`` take
NCHW: the reference reads every input as NCHW whatever ``data_format``
says, and the port raises ``NotImplementedError`` on another.
``class_center_sample`` raises, as in the reference.
``embedding(sparse=True)`` gives a row-sparse gradient
(``framework/selected_rows.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import amp_cast_for_op, amp_op
from paddle_tpu_torch.framework.replay import note_generator
from paddle_tpu_torch.framework.selected_rows import sparse_allowed

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "pad", "zeropad2d", "interpolate",
           "upsample", "unfold", "fold", "bilinear", "cosine_similarity",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "label_smooth", "class_center_sample", "pairwise_distance"]


@amp_op("linear")
def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with weight (in_features, out_features), the
    reference's layout (``:19``)."""
    out = x @ weight
    return out if bias is None else out + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Dropout (reference ``:27``): keeps each entry (or each slice along
    ``axis``) with probability 1 - p, drawn from ``generator`` (the
    default generator of x's device when None); ``upscale_in_train``
    divides the kept entries by 1 - p.  The reference's bits come from
    jax.random and are not reproduced: only the distribution is.  Inside
    a recompute region the replay draws the forward's mask
    (``framework.replay.note_generator``)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    if not training or p == 0:
        return x
    (x,) = amp_cast_for_op("dropout", [x])
    if p == 1:
        # zeros on autograd's tape, whatever x holds: x gets a zero
        # gradient, as through the reference's zeros_like (x * 0 would
        # give NaN at an infinite x)
        return torch.where(torch.zeros((), dtype=torch.bool,
                                       device=x.device), x, 0.0)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    if generator is not None:
        note_generator(generator)
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Drops whole channels (reference ``:50``)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    """Drops whole channels of a volume (reference ``:55``)."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


@amp_op("alpha_dropout")
def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU's dropout (reference ``:60-76``): a dropped entry takes
    ``-alpha * scale``, then an affine map keeps the mean and variance."""
    if not training or p == 0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    if generator is not None:
        note_generator(generator)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < q
    return a_coef * torch.where(keep, x, alpha_p) + b_coef


class _SparseEmbedding(torch.autograd.Function):
    """The lookup whose backward gives the table a row-sparse gradient
    (reference ``_sparse_embedding`` :95-140): an uncoalesced sparse COO
    tensor with one row a looked-up id, the rows of ``padding_idx`` zero
    (``framework/selected_rows.py``)."""

    @staticmethod
    def forward(ctx, ids, weight, padding_idx):
        ctx.save_for_backward(ids)
        ctx.padding_idx = padding_idx
        ctx.table = tuple(weight.shape)
        return _lookup(ids, weight, padding_idx)

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        rows = ids.reshape(-1)
        flat = cot.reshape(rows.shape[0], ctx.table[1])
        if ctx.padding_idx is not None:
            flat = flat.masked_fill((rows == ctx.padding_idx)[:, None], 0.0)
        return None, torch.sparse_coo_tensor(
            rows[None], flat, ctx.table, check_invariants=False), None


def _lookup(ids, weight, padding_idx):
    out = torch.nn.functional.embedding(ids, weight)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


@amp_op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` looked up by the integer ids ``x`` (reference
    ``:77``); the rows of ids equal to ``padding_idx`` are zero and pass
    no gradient.  ``sparse=True`` gives a leaf table that requires grad a
    row-sparse gradient (reference ``:98``); the dense path is taken
    otherwise, and inside ``framework.selected_rows.dense_gradients``
    (the functional step), as the reference takes it under a trace."""
    ids = x.long()
    if (sparse and sparse_allowed() and torch.is_grad_enabled()
            and weight.is_leaf and weight.requires_grad):
        return _SparseEmbedding.apply(ids, weight, padding_idx)
    return _lookup(ids, weight, padding_idx)


@amp_op("one_hot")
def one_hot(x, num_classes, name=None):
    """f32 one-hot rows of the integer ids ``x`` (reference ``:143``, as
    ``jax.nn.one_hot``: an id outside [0, num_classes) gives a zero row)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(torch.float32)


@amp_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior_dist, the prior uniform over
    the last axis when not given (reference ``:376``)."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def _pad_index(n, lo, hi, mode, device):
    """Source rows of a dim of ``n`` padded by (lo, hi) in numpy's
    ``reflect``, ``edge`` or ``wrap`` mode."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    if n == 1:
        return torch.zeros_like(i)
    m = i.remainder(2 * (n - 1))
    return torch.where(m >= n, 2 * (n - 1) - m, m)


@amp_op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``jnp.pad`` of the reference (``:148-172``): ``pad`` holds a (low,
    high) pair for every dim, first dim first, or pairs for the spatial
    dims, innermost first; ``constant``, ``reflect``, ``replicate`` or
    ``circular``."""
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(q) for q in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise KeyError(mode)
    nd = x.dim()
    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        pairs = [(0, 0)] * nd
        inner = nd - 1 if data_format in ("NCHW", "NCL", "NCDHW") else nd - 2
        for i in range(len(pad) // 2):
            pairs[inner - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        return F.pad(x, [q for lo_hi in reversed(pairs) for q in lo_hi],
                     value=value)
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def _f32(v, device):
    """A Python float as JAX's weak-typed f32 scalar."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def linspace(start, stop, num, device):
    """jnp.linspace(start, stop, num) in f32, as JAX forms it:
    start * (1 - s) + stop * s at s = i / (num - 1), the last value stop."""
    if num == 1:
        return _f32(start, device)[None]
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    start, stop = _f32(start, device), _f32(stop, device)
    return torch.cat([start * (1 - s) + stop * s, stop[None]])


def _nearest_rows(i_s, o_s, device):
    """floor(arange(o_s) * (i_s / o_s)) in f32, as the reference."""
    ar = torch.arange(o_s, dtype=torch.float32, device=device)
    return torch.floor(ar * _f32(i_s / o_s, device)).long()


def _resize_weights(i_s, o_s, cubic, device):
    """jax.image's (in, out) weight matrix of one dim: scale o_s / i_s, no
    translation, antialiased (``compute_weight_mat``)."""
    f32 = torch.float32
    inv = 1.0 / (o_s / i_s)
    kernel_scale = _f32(max(inv, 1.0), device)
    sample = ((torch.arange(o_s, dtype=f32, device=device) + 0.5)
              * _f32(inv, device) - _f32(0.0 * inv, device) - 0.5)
    x = (sample[None, :] - torch.arange(i_s, dtype=f32, device=device)[
        :, None]).abs() / kernel_scale
    if cubic:    # Keys' kernel, a = -0.5
        w = ((1.5 * x - 2.5) * x) * x + 1.0
        w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
        w = torch.where(x >= 2.0, 0.0, w)
    else:
        w = torch.clamp_min(1 - x.abs(), 0)
    total = w.sum(0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= i_s - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _corner_weights(i_s, o_s, device):
    """(in, out) weights of map_coordinates(order=1, mode="nearest") at
    jnp.linspace(0, i_s - 1, o_s)."""
    coord = (torch.zeros(1, dtype=torch.float32, device=device) if o_s == 1
             else linspace(0.0, i_s - 1, o_s, device))
    lower = torch.floor(coord)
    upper_w = coord - lower
    lower = lower.long()
    cols = torch.arange(o_s, device=device)
    w = torch.zeros(i_s, o_s, dtype=torch.float32, device=device)
    w.index_put_((lower.clamp(0, i_s - 1), cols), 1 - upper_w,
                  accumulate=True)
    w.index_put_(((lower + 1).clamp(0, i_s - 1), cols), upper_w,
                 accumulate=True)
    return w


def _contract(x, axis, w):
    """x with dim ``axis`` mapped through the (in, out) matrix w."""
    return torch.tensordot(x, w.to(x.dtype), dims=([axis], [0])).movedim(
        -1, axis)


@amp_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    mode = mode.lower()
    nd = x.dim()
    axes = (list(range(1, nd - 1))
            if data_format in ("NHWC", "NWC", "NDHWC")
            else list(range(2, nd)))
    in_sizes = [x.shape[a] for a in axes]
    if size is not None:
        sz = size.tolist() if isinstance(size, torch.Tensor) else size
        out_sizes = [int(v) for v in (sz if isinstance(sz, (list, tuple))
                                      else [sz] * len(axes))]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(axes))
        out_sizes = [int(i * f) for i, f in zip(in_sizes, sf)]
    out = x
    if mode == "nearest":
        for a, i_s, o_s in zip(axes, in_sizes, out_sizes):
            out = out.index_select(a, _nearest_rows(i_s, o_s, x.device))
        return out
    if mode in ("bilinear", "linear", "trilinear", "bicubic"):
        for a, i_s, o_s in zip(axes, in_sizes, out_sizes):
            if align_corners:
                out = _contract(out, a, _corner_weights(i_s, o_s, x.device))
            elif i_s != o_s:
                out = _contract(out, a, _resize_weights(
                    i_s, o_s, mode == "bicubic", x.device))
        return out
    if mode == "area":
        for a, o_s in zip(axes, out_sizes):
            i_s = out.shape[a]
            if i_s % o_s == 0:
                out = out.unflatten(a, (o_s, i_s // o_s)).mean(a + 1)
            else:
                out = out.index_select(a, _nearest_rows(i_s, o_s, x.device))
        return out
    raise ValueError(f"unsupported interpolate mode {mode}")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@amp_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col (reference ``:256-284``): (N, C * kh * kw, L); ``paddings``
    an int, (h, w) or (top, bottom, left, right)."""
    if isinstance(paddings, int):
        pads = (paddings,) * 4
    elif len(paddings) == 2:
        pads = (paddings[0], paddings[0], paddings[1], paddings[1])
    else:
        pads = tuple(paddings)
    x = F.pad(x, [pads[2], pads[3], pads[0], pads[1]])
    return F.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                    stride=_pair(strides))


@amp_op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the sum of overlapping patches (reference ``:287-312``)."""
    return F.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                  dilation=_pair(dilations), padding=_pair(paddings),
                  stride=_pair(strides))


@amp_op("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias), weight (out, in1,
    in2)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


@amp_op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """dot / max(|x1| |x2|, eps) along ``axis``."""
    dot = (x1 * x2).sum(axis)
    norms = (x1 * x1).sum(axis).sqrt() * (x2 * x2).sum(axis).sqrt()
    return dot / torch.maximum(norms, norms.new_tensor(eps))


@amp_op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """(sum |x - y + epsilon|^p)^(1/p) over the last dim."""
    d = x - y + epsilon
    return (d.abs() ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


def _nchw(fn, data_format):
    if data_format != "NCHW":
        raise NotImplementedError(
            f"{fn}(data_format={data_format!r}): the reference reads every "
            "input as NCHW; the port takes NCHW only")


@amp_op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    _nchw("pixel_shuffle", data_format)
    r = upscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


@amp_op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    _nchw("pixel_unshuffle", data_format)
    r = downscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


@amp_op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    _nchw("channel_shuffle", data_format)
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def class_center_sample(label, num_classes, num_samples, group=None):
    raise NotImplementedError(
        "class_center_sample: PS-style class sampling is not ported (the "
        "reference raises too)")
