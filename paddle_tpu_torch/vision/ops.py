"""Vision ops, the dense detection half (port of paddle_tpu/vision/ops.py
``:24-378``, ``:628-951``): box utilities, priors and anchors, the YOLOv3
decode and loss, RoIAlign / RoIPool, the focal loss, the EAST transform
and deformable convolution with its layer.  ``nms`` and the host-side
target stages are not ported yet.

Every function computes on its inputs' device; tensors made from shapes
alone (priors, anchors, variances) go to the device of ``input``.  Each
op that the reference runs through ``apply`` under a name is an AMP op of
that name.  The reference's gradient rules are kept where PyTorch's
differ: its ``jnp.clip`` and ``jnp.maximum`` split the gradient evenly at
a tie (``torch.maximum`` / ``torch.minimum`` here, never ``clamp``), and
its reduce-max splits it evenly among tied maxima (``amax``).

- ``prior_box``, ``anchor_generator`` and ``density_prior_box`` are the
  reference's host numpy, copied, so their values are bitwise its own.
- ``roi_align`` takes one sample at each bin's centre whatever
  ``sampling_ratio`` says; a sample outside the map reads the clamped
  border (the floor clipped to [0, H - 1], the weights ``clip(y - y0, 0,
  1)``); gradients reach ``x`` and ``boxes``.
- ``roi_pool`` bins are ``floor`` / ``ceil`` of the scaled corners, split
  at ``floor(i * h / oh)`` and ``ceil((i + 1) * h / oh)``, clipped to the
  map; an empty bin gives 0.  Each bin's window is gathered up to the
  largest bin extent (one host read of that extent), RoIs in chunks of at
  most ``_POOL_BUDGET`` window values, and the backward recomputes each
  chunk: memory grows with the windows, never with R x C x H x W.  The
  max runs over rows first, then columns, as the reference's.
- ``deform_conv2d``'s offsets are (dy, dx) interleaved per tap; each
  bilinear corner outside the map is zeroed on its own; the f32 im2col
  product runs in full f32 on the card whatever TF32 flags say.
- ``yolo_loss`` returns (N,); rows of ``gt_box`` with w <= 0 or a label
  below 0 are padding.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.amp import amp_op
from paddle_tpu_torch.nn.functional.conv import _ieee_f32
from paddle_tpu_torch.nn.initializer import XavierUniform
from paddle_tpu_torch.nn.layer.common import make_param
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["box_iou", "roi_align", "roi_pool", "yolo_box", "prior_box",
           "box_coder", "iou_similarity", "box_clip", "anchor_generator",
           "density_prior_box", "sigmoid_focal_loss",
           "polygon_box_transform", "deform_conv2d", "yolo_loss",
           "DeformConv2D"]

# window values (R x C x bins x extents) roi_pool gathers at once
_POOL_BUDGET = 1 << 25


def _max(a, v):
    """max(a, v) with JAX's gradient: half of it each at a tie."""
    return torch.maximum(a, v if isinstance(v, torch.Tensor)
                         else a.new_full((), v))


def _min(a, v):
    return torch.minimum(a, v if isinstance(v, torch.Tensor)
                         else a.new_full((), v))


def _clip(a, lo, hi):
    """``jnp.clip``: max, then min, each splitting a tie's gradient."""
    return _min(_max(a, lo), hi)


def _const(values, like, dtype=None):
    """A small host constant on ``like``'s device; to the card from pinned
    memory, so that the copy does not wait for the card's queue."""
    t = torch.as_tensor(values, dtype=dtype)
    if like.device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(like.device, non_blocking=True)
    return t.to(like.device)


def _div(a, d):
    """a / d rounded as one IEEE division on every device: PyTorch's CUDA
    kernels multiply by the reciprocal of a Python divisor, an ulp off
    the reference's quotient (and, at RoIAlign's sample positions of a
    few hundred pixels, 1e-4 off in the sampled value)."""
    return a / a.new_full((), d)


@amp_op("box_iou")
def box_iou(boxes1, boxes2):
    """IoU matrix between (N, 4) and (M, 4) xyxy boxes."""
    b1, b2 = boxes1, boxes2
    area1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    area2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = _max(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / _max(area1[:, None] + area2[None] - inter, 1e-10)


@amp_op("box_coder")
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True):
    """Encode or decode (M, 4) boxes against (M, 4) priors and their
    variances (reference ``:234-259``)."""
    pb, pbv, tb = prior_box, prior_box_var, target_box
    one = 0 if box_normalized else 1
    pw = pb[:, 2] - pb[:, 0] + one
    ph = pb[:, 3] - pb[:, 1] + one
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + one
        th = tb[:, 3] - tb[:, 1] + one
        tcx = tb[:, 0] + tw / 2
        tcy = tb[:, 1] + th / 2
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], 1)
        return out / pbv
    d = tb * pbv
    dcx = d[:, 0] * pw + pcx
    dcy = d[:, 1] * ph + pcy
    dw = torch.exp(d[:, 2]) * pw
    dh = torch.exp(d[:, 3]) * ph
    return torch.stack([dcx - dw / 2, dcy - dh / 2, dcx + dw / 2,
                        dcy + dh / 2], 1)


@amp_op("iou_similarity")
def iou_similarity(x, y, box_normalized=True):
    """(N, 4) x (M, 4) -> (N, M) IoU; unnormalised boxes count the closing
    pixel (+1 on each extent)."""
    off = 0.0 if box_normalized else 1.0
    a1 = (x[:, 2] - x[:, 0] + off) * (x[:, 3] - x[:, 1] + off)
    a2 = (y[:, 2] - y[:, 0] + off) * (y[:, 3] - y[:, 1] + off)
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = _max(rb - lt + off, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / _max(a1[:, None] + a2[None] - inter, 1e-10)


@amp_op("box_clip")
def box_clip(input, im_shape):
    """(.., 4) xyxy boxes clipped into [0, w - 1] x [0, h - 1];
    ``im_shape`` (h, w) per image or one pair, non-differentiable."""
    s = torch.as_tensor(im_shape).detach().to(input.device, input.dtype)
    h, w = s[..., 0], s[..., 1]
    b = input
    return torch.stack([_clip(b[..., 0], 0.0, w - 1),
                        _clip(b[..., 1], 0.0, h - 1),
                        _clip(b[..., 2], 0.0, w - 1),
                        _clip(b[..., 3], 0.0, h - 1)], -1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5):
    """SSD prior boxes: (H, W, P, 4) boxes and variances on ``input``'s
    device, built on the host as the reference does (``:194-231``):
    ``steps[1]`` for h, ``steps[0]`` for w, the max-size box after each
    min size, ``flip`` adding 1 / a."""
    H, W = (input.shape[2], input.shape[3])
    img_h, img_w = (image.shape[2], image.shape[3])
    step_h = steps[1] or img_h / H
    step_w = steps[0] or img_w / W
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]
    boxes = []
    for h in range(H):
        for w in range(W):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            for k, ms in enumerate(min_sizes):
                boxes.append([cx - ms / 2, cy - ms / 2, cx + ms / 2,
                              cy + ms / 2])
                if max_sizes:
                    rs = (ms * max_sizes[k]) ** 0.5
                    boxes.append([cx - rs / 2, cy - rs / 2, cx + rs / 2,
                                  cy + rs / 2])
                for a in ars:
                    if a == 1.0:
                        continue
                    bw = ms * a ** 0.5 / 2
                    bh = ms / a ** 0.5 / 2
                    boxes.append([cx - bw, cy - bh, cx + bw, cy + bh])
    arr = np.asarray(boxes, np.float32)
    arr[:, 0::2] /= img_w
    arr[:, 1::2] /= img_h
    if clip:
        arr = arr.clip(0, 1)
    var = np.tile(np.asarray(variance, np.float32)[None], (len(arr), 1))
    return (_on(arr.reshape(H, W, -1, 4), input),
            _on(var.reshape(H, W, -1, 4), input))


def _on(a, like):
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


def anchor_generator(input, anchor_sizes, aspect_ratios, variances=None,
                     stride=(16.0, 16.0), offset=0.5):
    """Anchors at every position of an (N, C, H, W) map: (H, W, A, 4)
    anchors and variances on ``input``'s device (reference ``:299-323``,
    host numpy)."""
    H, W = int(input.shape[-2]), int(input.shape[-1])
    sw, sh = float(stride[0]), float(stride[1])
    variances = list(variances or [0.1, 0.1, 0.2, 0.2])
    ws, hs = [], []
    for r in aspect_ratios:
        for s in anchor_sizes:
            ws.append(s / np.sqrt(r))
            hs.append(s * np.sqrt(r))
    ws = np.asarray(ws, np.float32)
    hs = np.asarray(hs, np.float32)
    cx = (np.arange(W, dtype=np.float32) + offset) * sw
    cy = (np.arange(H, dtype=np.float32) + offset) * sh
    cxg, cyg = np.meshgrid(cx, cy)
    boxes = np.stack([
        cxg[..., None] - 0.5 * ws, cyg[..., None] - 0.5 * hs,
        cxg[..., None] + 0.5 * ws, cyg[..., None] + 0.5 * hs], -1)
    var = np.broadcast_to(np.asarray(variances, np.float32), boxes.shape)
    return _on(boxes.astype(np.float32), input), _on(var, input)


def density_prior_box(input, image=None, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variances=None, clip=False,
                      steps=(0.0, 0.0), offset=0.5):
    """SSD density prior boxes (reference ``:326-378``, host numpy): each
    (fixed_size, density) pair lays density^2 shifted boxes a cell for
    every fixed ratio; (H, W, A, 4) boxes and variances on ``input``'s
    device."""
    H, W = int(input.shape[-2]), int(input.shape[-1])
    if image is not None:
        IH, IW = int(image.shape[-2]), int(image.shape[-1])
    else:
        IH = IW = None
    step_w = float(steps[0]) or (IW / W if IW else 1.0)
    step_h = float(steps[1]) or (IH / H if IH else 1.0)
    variances = list(variances or [0.1, 0.1, 0.2, 0.2])
    dcx, dcy, bws, bhs = [], [], [], []
    for size, dens in zip(fixed_sizes, densities):
        shift = size / dens
        for ratio in fixed_ratios:
            bw = size * np.sqrt(ratio)
            bh = size / np.sqrt(ratio)
            d = np.arange(dens, dtype=np.float32)
            sx = (-size / 2 + shift / 2 + d * shift)
            gx, gy = np.meshgrid(sx, sx)
            dcx.extend(gx.ravel())
            dcy.extend(gy.ravel())
            bws.extend([bw] * dens * dens)
            bhs.extend([bh] * dens * dens)
    dcx = np.asarray(dcx, np.float32)
    dcy = np.asarray(dcy, np.float32)
    bws = np.asarray(bws, np.float32)
    bhs = np.asarray(bhs, np.float32)
    ccx = ((np.arange(W, dtype=np.float32) + offset) * step_w)[None, :]
    ccy = ((np.arange(H, dtype=np.float32) + offset) * step_h)[:, None]
    A = len(dcx)
    scx = np.broadcast_to(ccx[..., None] + dcx, (H, W, A))
    scy = np.broadcast_to(ccy[..., None] + dcy, (H, W, A))
    boxes = np.stack([scx - bws / 2, scy - bhs / 2,
                      scx + bws / 2, scy + bhs / 2], -1).astype(np.float32)
    if IW:
        boxes[..., 0::2] /= IW
        boxes[..., 1::2] /= IH
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32), boxes.shape)
    return _on(boxes, input), _on(var, input)


@amp_op("yolo_box")
def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0):
    """Decode a YOLOv3 head (N, A * (5 + C), H, W): (N, A * H * W, 4)
    xyxy boxes in pixels of ``img_size`` (N, 2) = (h, w), clipped to
    ``img - 1`` with ``clip_bbox``, and (N, A * H * W, C) scores; boxes and
    scores are zeroed where the objectness is not above
    ``conf_thresh``."""
    na = len(anchors) // 2
    N, _, H, W = x.shape
    x_ = x.reshape(N, na, 5 + class_num, H, W)
    gx = torch.arange(W, device=x.device, dtype=x.dtype)[None, None, None]
    gy = torch.arange(H, device=x.device, dtype=x.dtype)[None, None, :,
                                                          None]
    bx = _div(torch.sigmoid(x_[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
              + gx, W)
    by = _div(torch.sigmoid(x_[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
              + gy, H)
    an = _const(anchors, x, torch.float32)
    aw = an[0::2][None, :, None, None]
    ah = an[1::2][None, :, None, None]
    bw = _div(torch.exp(x_[:, :, 2]) * aw, W * downsample_ratio)
    bh = _div(torch.exp(x_[:, :, 3]) * ah, H * downsample_ratio)
    conf = torch.sigmoid(x_[:, :, 4])
    probs = torch.sigmoid(x_[:, :, 5:]) * conf[:, :, None]
    imgh = img_size[:, 0].to(torch.float32)[:, None]
    imgw = img_size[:, 1].to(torch.float32)[:, None]
    bx, by, bw, bh = (a.reshape(N, -1) for a in (bx, by, bw, bh))
    x1 = (bx - bw / 2) * imgw
    y1 = (by - bh / 2) * imgh
    x2 = (bx + bw / 2) * imgw
    y2 = (by + bh / 2) * imgh
    if clip_bbox:
        x1 = _clip(x1, 0.0, imgw - 1)
        y1 = _clip(y1, 0.0, imgh - 1)
        x2 = _clip(x2, 0.0, imgw - 1)
        y2 = _clip(y2, 0.0, imgh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, -1, class_num)
    keep = (conf.reshape(N, -1) > conf_thresh)[..., None]
    return boxes * keep, scores * keep


def _roi_image_index(boxes_num, n_rois, x):
    """boxes_num [N] -> each RoI's image index [R] on ``x``'s device,
    built there (no read back to the host); None -> every RoI samples
    image 0."""
    if boxes_num is None:
        return torch.zeros(n_rois, dtype=torch.long, device=x.device)
    bn = _const(boxes_num, x, torch.long)
    return torch.repeat_interleave(
        torch.arange(bn.numel(), device=x.device), bn, output_size=n_rois)


@amp_op("roi_align")
def roi_align(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign of x (N, C, H, W) over boxes (R, 4) xyxy in input scale:
    (R, C, oh, ow), one bilinear sample at each bin's centre
    (``sampling_ratio`` is read by nothing, as in the reference);
    ``boxes_num`` [N] assigns RoIs to images in order (None: all to image
    0)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    N, C, H, W = x.shape
    R = boxes.shape[0]
    img = _roi_image_index(boxes_num, R, x)
    off = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - off
    y1 = boxes[:, 1] * spatial_scale - off
    x2 = boxes[:, 2] * spatial_scale - off
    y2 = boxes[:, 3] * spatial_scale - off
    bh = _div(y2 - y1, oh)
    bw = _div(x2 - x1, ow)
    ys = y1[:, None] + (torch.arange(oh, device=x.device,
                                     dtype=boxes.dtype) + 0.5) * bh[:, None]
    xs = x1[:, None] + (torch.arange(ow, device=x.device,
                                     dtype=boxes.dtype) + 0.5) * bw[:, None]
    y0 = ys.detach().floor().clamp(0, H - 1)
    x0 = xs.detach().floor().clamp(0, W - 1)
    wy = _clip(ys - y0, 0.0, 1.0)[:, :, None, None]   # (R, oh, 1, 1)
    wx = _clip(xs - x0, 0.0, 1.0)[:, None, :, None]   # (R, 1, ow, 1)
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = (y0i + 1).clamp(max=H - 1), (x0i + 1).clamp(max=W - 1)
    xf = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    base = img[:, None, None] * (H * W)

    def at(yi, xi):                                   # (R, oh, ow, C)
        idx = base + yi[:, :, None] * W + xi[:, None, :]
        return xf.index_select(0, idx.reshape(-1)).reshape(R, oh, ow, C)
    val = (at(y0i, x0i) * (1 - wy) * (1 - wx) + at(y0i, x1i) * (1 - wy) * wx
           + at(y1i, x0i) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return val.permute(0, 3, 1, 2).contiguous()


def _pool_bins(lo_hi, spatial_scale, n, size):
    """Each RoI's bins along one axis: (start (R, n), length (R, n)), the
    reference's ``floor(i h / n)`` .. ``ceil((i + 1) h / n)`` split of
    ``floor`` .. ``ceil`` of the scaled corners ``lo_hi`` (R, 2), clipped
    to [0, size]."""
    lo = torch.floor(lo_hi[:, 0] * spatial_scale).long()[:, None]
    hi = torch.ceil(lo_hi[:, 1] * spatial_scale).long()[:, None]
    ext = (hi - lo).clamp(min=1)
    i = torch.arange(n, device=lo_hi.device)
    start = lo + torch.div(i * ext, n, rounding_mode="floor")
    end = lo - torch.div(-(i + 1) * ext, n, rounding_mode="floor")
    start, end = start.clamp(0, size), end.clamp(0, size)
    return start, (end - start).clamp(min=0)


def _pool_windows(xf, img, rows, cols, kh, kw, H, W):
    """Each bin's window, gathered from xf (N * H * W, C): (flat index
    (R, oh, kh, ow, kw), valid mask of that shape, values (..., C), -inf
    outside the bin)."""
    rk = torch.arange(kh, device=xf.device)
    ck = torch.arange(kw, device=xf.device)
    r = (rows[0][:, :, None] + rk).clamp(max=H - 1)    # (R, oh, kh)
    c = (cols[0][:, :, None] + ck).clamp(max=W - 1)    # (R, ow, kw)
    valid = ((rk < rows[1][:, :, None])[:, :, :, None, None]
             & (ck < cols[1][:, :, None])[:, None, None])
    idx = (img[:, None, None, None, None] * (H * W)
           + r[:, :, :, None, None] * W + c[:, None, None])
    win = torch.where(valid[..., None], xf[idx], -torch.inf)
    return idx, valid, win


class _RoiPool(torch.autograd.Function):
    """The two-stage masked max over each bin (rows, then columns) in
    RoI chunks; the backward recomputes each chunk's windows and splits
    the gradient among tied maxima as two reduce-maxes do: 1 / (ties
    among the rows of a column) x 1 / (ties among the columns)."""

    @staticmethod
    def forward(ctx, x, img, rows, cols, kh, kw):
        N, C, H, W = x.shape
        xf = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
        R, oh = rows[0].shape
        ow = cols[0].shape[1]
        out = x.new_zeros(R, oh, ow, C)
        chunk = max(1, _POOL_BUDGET // max(1, oh * kh * ow * kw * C))
        for s in range(0, R, chunk):
            sl = slice(s, s + chunk)
            _, _, win = _pool_windows(
                xf, img[sl], (rows[0][sl], rows[1][sl]),
                (cols[0][sl], cols[1][sl]), kh, kw, H, W)
            o = win.amax(2).amax(3)
            out[sl] = torch.where(torch.isfinite(o), o, 0.0)
        ctx.save_for_backward(x, img, *rows, *cols)
        ctx.conf = (kh, kw, chunk)
        return out.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, gout):
        x, img, r0, r1, c0, c1 = ctx.saved_tensors
        kh, kw, chunk = ctx.conf
        N, C, H, W = x.shape
        xf = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
        dxf = torch.zeros_like(xf)
        g = gout.permute(0, 2, 3, 1)                       # (R, oh, ow, C)
        for s in range(0, r0.shape[0], chunk):
            sl = slice(s, s + chunk)
            idx, valid, win = _pool_windows(xf, img[sl], (r0[sl], r1[sl]),
                                            (c0[sl], c1[sl]), kh, kw, H, W)
            t = win.amax(2)                                # (r, oh, ow, kw, C)
            o = t.amax(3)                                  # (r, oh, ow, C)
            gs = torch.where(torch.isfinite(o), g[sl], 0.0)
            at_c = t == o[:, :, :, None]
            gt = gs[:, :, :, None] * at_c / at_c.sum(3, keepdim=True)
            at_r = (win == t[:, :, None]) & valid[..., None]
            gx = gt[:, :, None] * at_r / at_r.sum(2, keepdim=True).clamp(
                min=1)
            dxf.index_add_(0, idx.reshape(-1), gx.reshape(-1, C))
        dx = dxf.reshape(N, H, W, C).permute(0, 3, 1, 2)
        return dx, None, None, None, None, None


@amp_op("roi_pool")
def roi_pool(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0):
    """RoIPool of x (N, C, H, W) over boxes (R, 4) xyxy: (R, C, oh, ow),
    the max of each bin (0 where the bin is empty).  No gradient reaches
    ``boxes`` (the reference's corners are integers)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    N, C, H, W = x.shape
    b = boxes.detach()
    img = _roi_image_index(boxes_num, b.shape[0], x)
    rows = _pool_bins(b[:, 1::2], spatial_scale, oh, H)
    cols = _pool_bins(b[:, 0::2], spatial_scale, ow, W)
    # the largest bin extents: one read back to the host
    kh, kw = (max(1, int(v)) for v in torch.stack(
        [rows[1].amax(), cols[1].amax()]).tolist()) if len(b) else (1, 1)
    return _RoiPool.apply(x, img, rows, cols, kh, kw)


@amp_op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    """Focal loss on sigmoid logits, the ``vision.ops`` form (reference
    ``:628-651``): the log-sigmoid cross-entropy, ``reduction="sum"`` by
    default; ``label`` (a same-shape float one-hot) and ``normalizer``
    take no gradient."""
    t = label.detach().to(logit.dtype)
    p = torch.sigmoid(logit)
    ce = -(t * torch.nn.functional.logsigmoid(logit)
           + (1 - t) * torch.nn.functional.logsigmoid(-logit))
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer.detach()
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


@amp_op("polygon_box_transform")
def polygon_box_transform(input):
    """EAST's quad geometry: channel 2k holds x offsets, 2k + 1 y
    offsets; the output is 4 x the grid coordinate less the input."""
    N, C, H, W = input.shape
    xs = torch.arange(W, device=input.device, dtype=input.dtype)
    ys = torch.arange(H, device=input.device, dtype=input.dtype)
    even = (torch.arange(C, device=input.device) % 2 == 0)[:, None, None]
    grid = torch.where(even, 4 * xs[None, None, :] + 0 * ys[None, :, None],
                       4 * ys[None, :, None] + 0 * xs[None, None, :])
    return grid[None] - input


class _F32Product(torch.autograd.Function):
    """w (G, O, K) @ cols (N, G, K, P) -> (N, G, O, P), forward and
    backward in full f32 on the card (never TF32)."""

    @staticmethod
    def forward(ctx, w, cols):
        ctx.save_for_backward(w, cols)
        with _ieee_f32():
            return torch.matmul(w, cols)

    @staticmethod
    def backward(ctx, g):
        w, cols = ctx.saved_tensors
        dw = dcols = None
        with _ieee_f32():
            if ctx.needs_input_grad[0]:
                dw = torch.matmul(g, cols.transpose(-1, -2)).sum(0)
            if ctx.needs_input_grad[1]:
                dcols = torch.matmul(w.transpose(-1, -2), g)
        return dw, dcols


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@amp_op("deform_conv2d")
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (v2 with ``mask``): every tap of the
    kernel samples x bilinearly at its grid point moved by ``offset``
    (N, 2 * dg * kh * kw, Ho, Wo), (dy, dx) per tap; ``mask`` (N, dg * kh *
    kw, Ho, Wo) scales each tap; then the grouped im2col product with
    ``weight`` (Cout, Cin / groups, kh, kw)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    dg = deformable_groups
    N, Cin, H, W = x.shape
    Cout, Cin_g, kh, kw = weight.shape
    K = kh * kw
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev, dt = x.device, x.dtype
    oy = (torch.arange(Ho, device=dev) * sh - ph)[None, :, None]
    ox = (torch.arange(Wo, device=dev) * sw - pw)[None, None, :]
    ky = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw)[:, None,
                                                                   None]
    kx = (torch.arange(kw, device=dev) * dw).repeat(kh)[:, None, None]
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    py = (oy + ky).to(dt) + off[:, :, :, 0]            # (N, dg, K, Ho, Wo)
    px = (ox + kx).to(dt) + off[:, :, :, 1]
    y0 = py.detach().floor()
    x0 = px.detach().floor()
    wy = py - y0
    wx = px - x0
    y0i, x0i = y0.long(), x0.long()
    xg = x.reshape(N, dg, Cin // dg, H * W)
    P = K * Ho * Wo

    def corner(dy, dx):
        yc, xc = y0i + dy, x0i + dx
        inb = ((yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1))
        idx = yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)
        v = torch.gather(xg, 3, idx.reshape(N, dg, 1, P).expand(
            N, dg, Cin // dg, P))
        return v.reshape(N, dg, Cin // dg, K, Ho, Wo) * inb[:, :, None].to(dt)
    val = (corner(0, 0) * ((1 - wy) * (1 - wx))[:, :, None]
           + corner(0, 1) * ((1 - wy) * wx)[:, :, None]
           + corner(1, 0) * (wy * (1 - wx))[:, :, None]
           + corner(1, 1) * (wy * wx)[:, :, None])
    if mask is not None:
        val = val * mask.reshape(N, dg, 1, K, Ho, Wo)
    cols = val.reshape(N, groups, (Cin // groups) * K, Ho * Wo)
    wg = weight.reshape(groups, Cout // groups, Cin_g * K)
    if dt == torch.float32 and dev.type == "cuda":
        out = _F32Product.apply(wg, cols)
    else:
        out = torch.matmul(wg, cols)
    out = out.reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _bce(logit, t):
    """max(l, 0) - l t + log1p(exp(-|l|)), JAX's gradient at l = 0."""
    return _max(logit, 0.0) - logit * t + torch.log1p(torch.exp(-logit.abs()))


@amp_op("yolo_loss")
def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 loss of one head x (N, S * (5 + C), H, W), (N,) (reference
    ``:761-894``): each gt (``gt_box`` (N, B, 4) xywh in input pixels) goes
    to its best wh-IoU anchor among all, the first on a tie; sigmoid BCE
    on x / y (the clipped log form where ``scale_x_y != 1``), objectness
    and classes, L1 on w / h, box terms weighted (2 - w h) x score; the
    objectness of a cell that is no gt's is ignored where its decoded box
    overlaps a gt above ``ignore_thresh``.  ``gt_label`` and ``gt_score``
    (mixup) take no gradient."""
    am = list(anchor_mask)
    S = len(am)
    C = int(class_num)
    N, _, H, W = x.shape
    dev, dt = x.device, x.dtype
    x5 = x.reshape(N, S, 5 + C, H, W)
    plx, ply = x5[:, :, 0], x5[:, :, 1]
    plw, plh = x5[:, :, 2], x5[:, :, 3]
    pobj = x5[:, :, 4]
    input_size = float(downsample_ratio * H)
    an = _const(anchors, x, torch.float32).reshape(-1, 2)
    am_t = _const(am, x)
    man = an[am_t]                                     # (S, 2)

    gwp, ghp = gt_box[..., 2], gt_box[..., 3]
    glab = gt_label.detach().long()
    valid = (gwp > 0) & (glab >= 0)
    score = (gt_score.detach() if gt_score is not None
             else torch.ones_like(gwp))

    with torch.no_grad():
        inter = torch.minimum(gwp[..., None], an[:, 0]) * torch.minimum(
            ghp[..., None], an[:, 1])
        union = gwp[..., None] * ghp[..., None] + an[:, 0] * an[:, 1] - inter
        best = torch.argmax(inter / union.clamp(min=1e-10), -1)
        in_mask = best[..., None] == am_t              # (N, B, S)
        s_idx = torch.argmax(in_mask.to(torch.uint8), -1)
        pos = valid & in_mask.any(-1)

    gx = _div(gt_box[..., 0], input_size)
    gy = _div(gt_box[..., 1], input_size)
    gi = (gx * W).long().clamp(0, W - 1)          # truncated, as astype
    gj = (gy * H).long().clamp(0, H - 1)
    tx = gx * W - gi
    ty = gy * H - gj
    aw = man[s_idx][..., 0]
    ah = man[s_idx][..., 1]
    tw = torch.log(_max(gwp, 1e-10) / aw.clamp(min=1e-10))
    th = torch.log(_max(ghp, 1e-10) / ah.clamp(min=1e-10))
    box_w = (2.0 - _div(gwp, input_size) * _div(ghp, input_size)) * score

    n_ar = torch.arange(N, device=dev)[:, None]

    def g(t):
        return t[n_ar, s_idx, gj, gi]                  # (N, B)
    if scale_x_y == 1.0:
        lxy = _bce(g(plx), tx) + _bce(g(ply), ty)
    else:
        eps = 1e-7
        sgx = _clip(torch.sigmoid(g(plx)) * scale_x_y
                    - 0.5 * (scale_x_y - 1.0), eps, 1 - eps)
        sgy = _clip(torch.sigmoid(g(ply)) * scale_x_y
                    - 0.5 * (scale_x_y - 1.0), eps, 1 - eps)
        lxy = -(tx * torch.log(sgx) + (1 - tx) * torch.log(1 - sgx)) \
            - (ty * torch.log(sgy) + (1 - ty) * torch.log(1 - sgy))
    lwh = (g(plw) - tw).abs() + (g(plh) - th).abs()
    t_pos, t_neg = (1.0 - 1.0 / C, 1.0 / C) if use_label_smooth else (1.0,
                                                                       0.0)
    onehot = (glab[..., None] == torch.arange(C, device=dev)).to(dt)
    tcls = onehot * t_pos + (1 - onehot) * t_neg
    pcls_g = x5[:, :, 5:][n_ar, s_idx, :, gj, gi]      # (N, B, C)
    lcls = _bce(pcls_g, tcls).sum(-1) * score
    posf = pos.to(dt)
    loss_box = ((lxy + lwh) * box_w * posf).sum(-1)
    loss_cls = (lcls * posf).sum(-1)

    with torch.no_grad():
        # objectness: the positive map by scatter-max, the ignore mask by
        # the decoded boxes' IoU against every valid gt
        flat = (((n_ar * S + s_idx) * H + gj) * W + gi).reshape(-1)
        posmap = torch.zeros(N * S * H * W, dtype=dt, device=dev)
        scoremap = posmap.scatter_reduce(0, flat, (score * posf).reshape(-1),
                                         "amax")
        posmap = posmap.scatter_reduce(0, flat, posf.reshape(-1), "amax")
        posmap = posmap.reshape(N, S, H, W)
        scoremap = scoremap.reshape(N, S, H, W)
        cx = torch.arange(W, device=dev, dtype=dt)
        cy = torch.arange(H, device=dev, dtype=dt)[:, None]
        bx = _div(torch.sigmoid(plx) * scale_x_y - 0.5 * (scale_x_y - 1.0)
                  + cx, W)
        by = _div(torch.sigmoid(ply) * scale_x_y - 0.5 * (scale_x_y - 1.0)
                  + cy, H)
        bw = _div(man[:, 0][None, :, None, None] * torch.exp(plw),
                  input_size)
        bh = _div(man[:, 1][None, :, None, None] * torch.exp(plh),
                  input_size)
        vf = valid.to(dt)
        gxn, gyn, gwn, ghn = ((a.detach() * vf)[:, :, None, None, None]
                              for a in (gx, gy, _div(gwp, input_size),
                                        _div(ghp, input_size)))
        bx_, by_, bw_, bh_ = (a[:, None] for a in (bx, by, bw, bh))
        ix = (torch.minimum(bx_ + bw_ / 2, gxn + gwn / 2)
              - torch.maximum(bx_ - bw_ / 2, gxn - gwn / 2)).clamp(min=0)
        iy = (torch.minimum(by_ + bh_ / 2, gyn + ghn / 2)
              - torch.maximum(by_ - bh_ / 2, gyn - ghn / 2)).clamp(min=0)
        i = ix * iy
        ious = i / (bw_ * bh_ + gwn * ghn - i).clamp(min=1e-10)
        max_iou = ious.amax(1)                         # (N, S, H, W)
        noobj = (max_iou < ignore_thresh).to(dt) * (1.0 - posmap)
    lobj = _bce(pobj, 1.0) * posmap * scoremap + _bce(pobj, 0.0) * noobj
    return loss_box + loss_cls + lobj.sum((1, 2, 3))


class DeformConv2D(Layer):
    """Layer form of ``deform_conv2d`` (reference ``:900-951``):
    ``weight`` (out, in / groups, kh, kw), Xavier-uniform, and ``bias``
    (out,), zeros (none with ``bias_attr=False``), on the card unless
    ``device="cpu"``; ``forward(x, offset, mask=None)``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, device=None):
        super().__init__()
        ks = list(_pair(kernel_size))
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        self.weight = make_param([out_channels, in_channels // groups] + ks,
                                 weight_attr, XavierUniform(), device=device)
        self.bias = make_param([out_channels], bias_attr, is_bias=True,
                               device=device)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, bias=self.bias,
                             stride=self._stride, padding=self._padding,
                             dilation=self._dilation,
                             deformable_groups=self._deformable_groups,
                             groups=self._groups, mask=mask)
