"""The functional long tail (port of paddle_tpu/nn/functional/extras.py):
``grid_sample``, ``affine_grid``, ``temporal_shift``,
``bilinear_tensor_product``, ``hsigmoid_loss``, ``diag_embed``, ``erf``,
``linear_chain_crf``, ``viterbi_decode``, ``sequence_conv`` and the
fluid-era aliases.

- ``grid_sample`` unnormalises the grid as the reference (``:89-93``),
  reflects about the borders by ``|v| mod span`` folded at the span, reads
  the four corners at indices clipped into the input, zeroes those outside
  it under ``padding_mode="zeros"``, and weighs them by the distance to the
  floor; ``nearest`` rounds half to even.  The defaults are the
  reference's (``align_corners=True``), not PyTorch's.
- ``affine_grid`` builds the (H, W, 3) base grid of ``jnp.linspace`` values
  and maps it by theta (N, 2, 3).
- ``linear_chain_crf`` takes ``transition`` (K + 2, K): row 0 start, row 1
  stop, the rest the K x K matrix; the forward algorithm runs a
  log-sum-exp a step, frozen past each length; returns the (B, 1) negative
  log-likelihoods.  ``viterbi_decode`` returns (scores (B,), int32 paths
  (B, T)), zero past each length; the first maximum wins a tie.
- ``roi_align``, ``roi_pool``, ``yolo_box``, ``prior_box`` and
  ``box_coder`` call ``vision.ops``, imported at the first call as the
  reference's ``_alias`` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.amp import amp_op
from paddle_tpu_torch.nn.functional import common as _common
from paddle_tpu_torch.nn.functional import loss as _loss
from paddle_tpu_torch.nn.functional import pooling as _pooling
from paddle_tpu_torch.nn.functional.activation import log_sigmoid

__all__ = ["grid_sample", "affine_grid", "temporal_shift",
           "linear_chain_crf", "viterbi_decode",
           "bilinear_tensor_product", "hsigmoid_loss", "diag_embed", "erf",
           # aliases
           "roi_align", "roi_pool", "yolo_box", "prior_box", "box_coder",
           "image_resize", "resize_bilinear", "resize_nearest", "smooth_l1",
           "warpctc", "fc", "pool2d", "sequence_conv"]


@amp_op("erf")
def erf(x, name=None):
    return torch.erf(x)


@amp_op("diag_embed")
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """Vectors along the last dim -> diagonal matrices, the two new dims
    placed at ``dim1`` and ``dim2`` (reference ``:37-60``)."""
    k = input.shape[-1]
    n = k + abs(offset)
    out = input.new_zeros(tuple(input.shape[:-1]) + (n, n))
    idx = torch.arange(k, device=input.device)
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = input
    nd = out.dim()
    src = {dim1 % nd: nd - 2, dim2 % nd: nd - 1}
    rest = iter(range(nd - 2))
    return out.permute([src[i] if i in src else next(rest)
                        for i in range(nd)])


@amp_op("affine_grid")
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta (N, 2, 3) and (N, C, H, W) -> the (N, H, W, 2) sampling grid
    in [-1, 1] (reference ``:63-84``)."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = (int(v) for v in out_shape)

    def base(n):
        if align_corners:
            return _common.linspace(-1.0, 1.0, n, theta.device)
        step = 2.0 / n
        return _common.linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                                theta.device)
    gy, gx = torch.meshgrid(base(h), base(w), indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,njk->nhwj", grid.to(theta.dtype), theta)


@amp_op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x (N, C, H, W) sampled at grid (N, H', W', 2) of (x, y) in [-1, 1]
    (reference ``:87-137``)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(mode)
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(padding_mode)
    n, _, h, w = x.shape

    def unnorm(coord, size):
        if align_corners:
            return (coord + 1) / 2 * (size - 1)
        return ((coord + 1) * size - 1) / 2
    gx, gy = unnorm(grid[..., 0], w), unnorm(grid[..., 1], h)
    if padding_mode == "reflection":
        def reflect(v, size):
            span = 2 * (size - 1) if align_corners else 2 * size
            v = v.abs().remainder(span if span > 0 else 1)
            return torch.minimum(v, span - v)
        gx, gy = reflect(gx, w), reflect(gy, h)
    rows = torch.arange(n, device=x.device)[:, None, None]

    def gather(iy, ix):
        out = x[rows, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            out = torch.where(valid[..., None], out, 0.0)
        return out                                    # (N, H', W', C)

    if mode == "nearest":
        out = gather(torch.round(gy).long(), torch.round(gx).long())
    else:
        fx, fy = torch.floor(gx), torch.floor(gy)
        x0, y0 = fx.long(), fy.long()
        wx, wy = (gx - fx)[..., None], (gy - fy)[..., None]
        out = (gather(y0, x0) * (1 - wx) * (1 - wy)
               + gather(y0, x0 + 1) * wx * (1 - wy)
               + gather(y0 + 1, x0) * (1 - wx) * wy
               + gather(y0 + 1, x0 + 1) * wx * wy)
    return out.permute(0, 3, 1, 2)


@amp_op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    """TSM's shift of (N * T, C, H, W) (reference ``:140-156``): the first
    ``shift_ratio * C`` channels come from t + 1, the next as many from
    t - 1, zeros at the ends."""
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    zero = v.new_zeros(v.shape[0], 1, c, h, w)
    fwd = torch.cat([v[:, 1:], zero], dim=1)
    bwd = torch.cat([zero, v[:, :-1]], dim=1)
    out = torch.cat([fwd[:, :, :c1], bwd[:, :, c1:c2], v[:, :, c2:]], dim=2)
    return out.reshape(nt, c, h, w)


@amp_op("bilinear_tensor_product")
def bilinear_tensor_product(x, y, weight, bias=None, name=None):
    """out[:, k] = x W_k y^T (+ bias)."""
    out = torch.einsum("bi,kij,bj->bk", x, weight, y)
    return out if bias is None else out + bias


def _default_tree(num_classes):
    """(path table, path code) of each class over the complete binary tree
    of ``num_classes`` leaves (reference ``:173-188``)."""
    nc = int(num_classes)
    depth = max(1, math.ceil(math.log2(max(nc, 2))))
    table = np.full((nc, depth), -1, np.int64)
    code = np.zeros((nc, depth), np.int64)
    for cls in range(nc):
        node = cls + (1 << depth)
        path = []
        while node > 1:
            path.append(((node // 2) - 1, node % 2))
            node //= 2
        for d, (nid, bit) in enumerate(reversed(path)):
            if nid < nc - 1:
                table[cls, d] = nid
                code[cls, d] = bit
    return table, code


@amp_op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """The sum of the binary cross-entropies along each sample's path to
    its class (reference ``:159-233``): the default tree's paths, or the
    given (N, L) ``path_table`` (node ids, -1 padding) and ``path_code``;
    returns (N, 1)."""
    if path_table is None:
        table, code = (torch.from_numpy(a).to(input.device)
                       for a in _default_tree(num_classes))
        lab = label.long()
        path_table, path_code = table[lab], code[lab]
    valid = path_table >= 0
    nodes = path_table.long().clamp_min(0)
    logits = torch.einsum("nld,nd->nl", weight[nodes], input)
    if bias is not None:
        logits = logits + bias[nodes]
    c = path_code.to(logits.dtype)
    loss = -(c * log_sigmoid(logits) + (1 - c) * log_sigmoid(-logits))
    return torch.where(valid, loss, 0.0).sum(1, keepdim=True)


def _vision_op(name):
    def fn(*args, **kwargs):
        from paddle_tpu_torch.vision import ops
        return getattr(ops, name)(*args, **kwargs)
    fn.__name__ = name
    fn.__doc__ = f"alias of vision.ops.{name}"
    return fn


roi_align = _vision_op("roi_align")
roi_pool = _vision_op("roi_pool")
yolo_box = _vision_op("yolo_box")
prior_box = _vision_op("prior_box")
box_coder = _vision_op("box_coder")


def image_resize(input, out_shape=None, scale=None, resample="BILINEAR",
                 **kw):
    return _common.interpolate(input, size=out_shape, scale_factor=scale,
                               mode=resample.lower())


def resize_bilinear(input, out_shape=None, scale=None, **kw):
    return image_resize(input, out_shape, scale, "BILINEAR")


def resize_nearest(input, out_shape=None, scale=None, **kw):
    return image_resize(input, out_shape, scale, "NEAREST")


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    return _loss.smooth_l1_loss(x, y, reduction="none")


def warpctc(input, label, input_length=None, label_length=None, blank=0,
            norm_by_times=False):
    return _loss.ctc_loss(input, label, input_length, label_length,
                          blank=blank)


def fc(x, size, num_flatten_dims=1, weight=None, bias=None, name=None):
    if weight is None:
        raise ValueError("fc is functional: pass weight explicitly (the "
                         "reference's global parameter scope does not "
                         "exist here)")
    return _common.linear(x, weight, bias)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, **kw):
    if global_pooling:
        pool_size = tuple(input.shape[2:])
    f = _pooling.max_pool2d if pool_type == "max" else _pooling.avg_pool2d
    return f(input, pool_size, pool_stride, pool_padding)


@amp_op("sequence_conv")
def sequence_conv(input, lengths, weight, bias=None, context_length=3,
                  padding=True, name=None):
    """Context windows of ``context_length`` steps (zero-padded, centred)
    projected by ``weight`` (context_length * D, out), zero past each
    length (reference ``:272-292``)."""
    b, t, d = input.shape
    half = context_length // 2
    ctx = torch.cat([input.new_zeros(b, half, d), input,
                     input.new_zeros(b, context_length - 1 - half, d)],
                    dim=1)
    windows = torch.cat([ctx[:, i:i + t] for i in range(context_length)],
                        dim=-1)
    out = torch.einsum("btk,ko->bto", windows, weight)
    if bias is not None:
        out = out + bias
    mask = torch.arange(t, device=input.device)[None, :] < lengths.long()[
        :, None]
    return torch.where(mask[..., None], out, 0.0)


def _full_lengths(emission, length):
    if length is None:
        return torch.full((emission.shape[0],), emission.shape[1],
                          dtype=torch.long, device=emission.device)
    return length.to(emission.device).long()


@amp_op("linear_chain_crf")
def linear_chain_crf(emission, transition, label, length=None, name=None):
    """The (B, 1) negative log-likelihoods of the gold tag paths (reference
    ``:295-346``)."""
    lens = _full_lengths(emission, length)
    b, t, _ = emission.shape
    start, stop, a = transition[0], transition[1], transition[2:]
    lab = label.long()
    alpha = start[None, :] + emission[:, 0]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + a[None], dim=1) \
            + emission[:, i]
        alpha = torch.where((i < lens)[:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)
    steps = torch.arange(t, device=emission.device)[None, :]
    valid = steps < lens[:, None]
    em_score = torch.where(valid, emission.gather(2, lab[:, :, None])[
        :, :, 0], 0.0).sum(1)
    tr_score = torch.where(steps[:, 1:] < lens[:, None],
                           a[lab[:, :-1], lab[:, 1:]], 0.0).sum(1)
    last = lab.gather(1, (lens - 1)[:, None])[:, 0]
    gold = em_score + tr_score + start[lab[:, 0]] + stop[last]
    return (log_z - gold)[:, None]


@amp_op("viterbi_decode")
def viterbi_decode(emission, transition, length=None,
                   include_start_end_tag=True, name=None):
    """(best scores (B,), best paths (B, T) int32) (reference ``:349-419``);
    with ``include_start_end_tag=False`` the transition is a plain K x K
    matrix and the start and stop scores are zero."""
    lens = _full_lengths(emission, length)
    b, t, k = emission.shape
    if include_start_end_tag:
        start, stop, a = transition[0], transition[1], transition[2:]
    else:
        start = stop = transition.new_zeros(transition.shape[1])
        a = transition
    alpha = start[None, :] + emission[:, 0]
    ident = torch.arange(k, device=emission.device).expand(b, k)
    backs = []
    for i in range(1, t):
        cand = alpha[:, :, None] + a[None]
        keep = (i < lens)[:, None]
        backs.append(torch.where(keep, cand.argmax(1), ident))
        alpha = torch.where(keep, cand.amax(1) + emission[:, i], alpha)
    final = alpha + stop[None, :]
    scores = final.amax(1)
    tag = final.argmax(1)
    rows = torch.arange(b, device=emission.device)
    path = [tag]
    for back in reversed(backs):
        tag = back[rows, tag]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    steps = torch.arange(t, device=emission.device)[None, :]
    return scores, torch.where(steps < lens[:, None], path, 0).to(
        torch.int32)
