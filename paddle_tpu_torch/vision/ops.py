"""Vision ops (port of paddle_tpu/vision/ops.py, all of it, in the
reference's order): box utilities, priors and anchors, the YOLOv3 decode
and loss, RoIAlign / RoIPool, the focal loss, the EAST transform,
deformable convolution with its layer, and the second half: the NMS family
(``nms``, ``multiclass_nms``, ``matrix_nms``, ``locality_aware_nms``), the
FPN proposal stages (``generate_proposals``, ``collect_fpn_proposals``,
``distribute_fpn_proposals``), the SSD, R-CNN and RetinaNet target stages
and ``roi_perspective_transform``.

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

The second half computes as host numpy and ``jnp`` in the reference,
because its output sizes depend on the data.  Here what is dense runs on
the input's device: IoU matrices, decodes, thresholds, sorts, gathers and
matrix NMS.  What the reference draws from numpy's ``Generator`` or scans
serially by nature is its numpy, copied, on the host: the fg / bg
sampling of ``rpn_target_assign`` and ``generate_proposal_labels``,
``locality_aware_nms``'s merge, the polygon rasterisation of
``generate_mask_labels`` and the homographies of
``roi_perspective_transform``.  Each function names its reads back to the
host; none reads once per kept box or per loop step.

- Greedy NMS (``_greedy_keep``) runs many groups (image x class, or image)
  at once: one (G, K, K) IoU tensor of the candidates ranked best first,
  by the reference's formula (no +1), then a scan over the ranks with no
  read back.  A box is suppressed where its IoU is not <= the threshold,
  compared in the boxes' dtype (numpy 2 rounds the Python threshold to
  f32 for an f32 IoU); ``eta`` < 1 shrinks each group's running threshold
  in f64 after every kept box while it is above 0.5.
- Scores rank by a stable sort: ties keep input order, where the
  reference's ``np.argsort`` (introsort) does not.  Detections are ordered
  by score with a stable sort over (class, rank) order, as the reference's
  ``list.sort``.
- The non-differentiable stages run under ``no_grad``: their outputs are
  constants, as the reference's numpy.  ``box_decoder_and_assign`` and
  ``roi_perspective_transform`` are differentiable, the latter in ``x``
  only.
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


@torch.no_grad()
def nms(boxes, scores=None, iou_threshold=0.3, top_k: int = -1):
    """Greedy NMS of (M, 4) xyxy boxes on their device: the kept indices
    (int64), best first.  Without ``scores`` the boxes rank in input
    order.  One read back to the host (the kept count)."""
    if scores is None:
        scores = torch.arange(len(boxes), 0, -1, device=boxes.device,
                              dtype=torch.float32)
    return _nms_keep(boxes, scores, iou_threshold, top_k=top_k)


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


def _k(x, v):
    """v as a 0-d tensor of x's dtype on x's device: a comparison with it
    rounds v to that dtype first, as numpy 2 does with a Python float."""
    return x.new_full((), v)


def _host(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


@torch.no_grad()
def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5):
    """Greedy bipartite matching over an (N, M) similarity matrix on its
    device: ``min(N, M)`` steps of the global argmax (the first maximum in
    row-major order), each closing its row and column, stopped for good at
    the first maximum <= 0 (a done flag, no read back); ``per_prediction``
    then matches each unmatched column to its row argmax where that is >=
    ``dist_threshold``.  Returns (match_indices (M,) int64, -1 where
    unmatched, match_dist (M,) f32)."""
    d = dist_matrix.detach().to(torch.float32)
    n, m = d.shape
    dev = d.device
    indices = torch.full((m,), -1, dtype=torch.long, device=dev)
    dist = torch.zeros(m, dtype=torch.float32, device=dev)
    work = d.clone()
    done = torch.zeros((), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    for _ in range(min(n, m)):
        flat = torch.argmax(work.reshape(-1))
        val = work.reshape(-1)[flat]
        done = done | (val <= 0)
        i, j = flat // m, flat % m
        hit = (cols == j) & ~done
        indices = torch.where(hit, i, indices)
        dist = torch.where(hit, val, dist)
        close = ((rows == i)[:, None] | (cols == j)[None]) & ~done
        work = torch.where(close, work.new_full((), -1.0), work)
    if match_type == "per_prediction":
        best = torch.argmax(d, 0)
        best_d = d.gather(0, best[None])[0]
        take = (indices == -1) & (best_d >= _k(best_d, dist_threshold))
        indices = torch.where(take, best, indices)
        dist = torch.where(take, best_d, dist)
    return indices, dist


# bytes of one (G, K, K) pair tensor the batched NMS forms at once; groups
# beyond it run in slices (the IoU's temporaries hold about three such)
_NMS_BUDGET = 1 << 30


def _pair_iou(b):
    """(G, K, 4) -> (G, K, K): the IoU of every pair of one group's boxes
    by the reference's ``_nms_keep`` formula and operation order, inter /
    max(a_i + a_j - inter, 1e-10), no +1 (symmetric, bitwise)."""
    x1, y1, x2, y2 = b.unbind(-1)
    w = torch.minimum(x2[:, :, None], x2[:, None])
    w -= torch.maximum(x1[:, :, None], x1[:, None])
    w.clamp_(min=0)
    h = torch.minimum(y2[:, :, None], y2[:, None])
    h -= torch.maximum(y1[:, :, None], y1[:, None])
    h.clamp_(min=0)
    inter = w.mul_(h)
    del h
    area = (x2 - x1) * (y2 - y1)
    den = area[:, :, None] + area[:, None]
    den -= inter
    return inter.div_(torch.maximum(den, _k(den, 1e-10)))


def _greedy_keep(boxes, valid, thresh, eta=1.0):
    """Greedy NMS of G groups at once.  ``boxes`` (G, K, 4) ranked best
    first in each group, ``valid`` (G, K) the candidates.  Returns keep
    (G, K) bool.  One (G, K, K) IoU tensor a slice of groups (at most
    ``_NMS_BUDGET`` bytes), then a scan over the ranks with no read back:
    rank r, unless suppressed, suppresses every later rank whose IoU with
    it is not <= the threshold (<= survives).  ``eta`` < 1 is the
    reference's adaptive threshold: after each kept box, while it is above
    0.5, it is multiplied by eta, in f64, one running value a group,
    rounded to the boxes' dtype for each comparison."""
    G, K = valid.shape
    keep = torch.zeros_like(valid)
    if G == 0 or K == 0:
        return keep
    step = max(1, _NMS_BUDGET // (K * K * boxes.element_size()))
    for s in range(0, G, step):
        iou = _pair_iou(boxes[s:s + step])
        supp = ~valid[s:s + step]
        if eta >= 1.0:
            over = ~(iou <= _k(iou, thresh))
            del iou
            for r in range(K - 1):
                tail = supp[:, r + 1:]
                tail |= over[:, r, r + 1:] > supp[:, r, None]
        else:
            thr = torch.full((len(supp),), float(thresh),
                             dtype=torch.float64, device=boxes.device)
            for r in range(K - 1):
                alive = ~supp[:, r]
                tail = supp[:, r + 1:]
                tail |= ~(iou[:, r, r + 1:] <= thr.to(iou.dtype)[:, None]) \
                    & alive[:, None]
                thr = torch.where(alive & (thr > 0.5), thr * eta, thr)
        keep[s:s + step] = ~supp
    return keep


def _cap(keep, top_k):
    """The first ``top_k`` kept ranks of each group (all with top_k <= 0):
    the greedy scan's earlier decisions do not depend on later ones."""
    if top_k > 0:
        keep = keep & (keep.cumsum(-1) <= top_k)
    return keep


def _nms_keep(boxes, scores, thresh, top_k=-1, eta=1.0):
    """Greedy NMS of one group (the reference's ``_nms_keep``): the kept
    indices, int64, best first.  Scores rank by a stable sort (ties in
    input order; the reference's ``np.argsort`` is not stable)."""
    order = torch.sort(scores, descending=True, stable=True).indices
    valid = torch.ones(1, len(order), dtype=torch.bool, device=boxes.device)
    keep = _cap(_greedy_keep(boxes[order][None], valid, thresh, eta), top_k)
    return order[keep[0]]


def _ranked(scores, score_threshold, nms_top_k):
    """Each row of ``scores`` (G, M) ranked by a stable descending sort and
    cut to the most candidates (score > threshold, at most ``nms_top_k``)
    of any row: (values, indices, valid), each (G, K).  One read back (K)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    valid = vals > _k(vals, score_threshold)
    count = valid.sum(-1)
    if nms_top_k > 0:
        count = count.clamp(max=nms_top_k)
    K = int(count.max()) if count.numel() else 0
    return vals[:, :K], idx[:, :K], valid[:, :K]


def _detections(n_img, labels, scores, boxes, index, sel, keep_top_k):
    """Rows [label, score, x1, y1, x2, y2] (f32) of every image's selected
    candidates, ordered by score with a stable sort over (class, rank)
    order, cut to ``keep_top_k`` an image.  ``labels`` (C,), the rest
    (N, C, K[, 4]).  Returns (out (D, 6), rois_num (N,) int32, index (D,)
    int64), one read back (the mask)."""
    dev = scores.device
    flat = scores.reshape(n_img, -1)
    sel = sel.reshape(n_img, -1)
    key = torch.where(sel, flat, _k(flat, -torch.inf))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    if keep_top_k > 0:
        order = order[:, :keep_top_k]
    take = sel.gather(1, order)
    C, K = scores.shape[1], scores.shape[2]
    lab = labels.to(dev, torch.float32)[order // K] if K else flat.new_zeros(
        order.shape, dtype=torch.float32)
    rows = torch.cat([lab[..., None], flat.gather(1, order)[..., None].to(
        torch.float32), boxes.reshape(n_img, C * K, 4)[
        torch.arange(n_img, device=dev)[:, None], order].to(torch.float32)],
        -1)
    return (rows[take], take.sum(1).to(torch.int32),
            index.reshape(n_img, -1).gather(1, order)[take])


def _class_groups(scores, background_label):
    """The classes that are not the background: (their labels (C',) on the
    scores' device, the scores (N, C', M))."""
    C = scores.shape[1]
    cls = torch.tensor([c for c in range(C) if c != background_label],
                       dtype=torch.long)
    return cls.to(scores.device), scores[:, cls.to(scores.device)]


@torch.no_grad()
def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=1000,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=-1, return_index=False):
    """Per-class greedy NMS and the cross-class top-k on the inputs' device
    (reference ``:441-479``): ``bboxes`` (N, M, 4), ``scores`` (N, C, M);
    every (image, class) is a group of one batched scan.  A class's
    candidates score strictly above ``score_threshold``, at most
    ``nms_top_k`` of the best; the background class is skipped.  Returns
    (out (D, 6) [label, score, x1, y1, x2, y2] f32, rois_num (N,) int32)
    and with ``return_index`` the flat indices n * M + m (int64).  Two
    reads back (the candidate count, the kept mask).  ``normalized`` is
    read by nothing, as in the reference."""
    N, _, M = scores.shape
    cls, s = _class_groups(scores, background_label)
    Cp = len(cls)
    vals, idx, valid = _ranked(s.reshape(N * Cp, M), score_threshold,
                               nms_top_k)
    K = vals.shape[1]
    img = torch.arange(N, device=s.device).repeat_interleave(Cp)[:, None]
    boxes = bboxes[img, idx]                                 # (N C', K, 4)
    keep = _greedy_keep(boxes, valid, nms_threshold, nms_eta)
    out, num, index = _detections(
        N, cls, vals.reshape(N, Cp, K), boxes.reshape(N, Cp, K, 4),
        (img * M + idx).reshape(N, Cp, K), keep.reshape(N, Cp, K),
        keep_top_k)
    return (out, num, index) if return_index else (out, num)


@torch.no_grad()
def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=-1):
    """Matrix (decay) NMS of SOLOv2 (reference ``:482-544``), dense on the
    inputs' device, batched over (image, class): over each class's
    candidates ranked best first, ``triu(iou, 1)``, each column's max IoU
    with a better box, the decay of column j by row i ``(1 - iou_ij) /
    max(1 - max_iou_i, 1e-10)`` (Gaussian: ``exp(-(iou_ij^2 - max_iou_i^2)
    / sigma)``), its min over i < j (1 for the best box), scores times
    ``min(decay, 1)`` kept strictly above ``post_threshold``.  Returns
    (out (D, 6) f32, rois_num (N,) int32, index (D,) int64); two reads
    back (the candidate count, the kept mask)."""
    N, _, M = scores.shape
    cls, s = _class_groups(scores, background_label)
    Cp = len(cls)
    vals, idx, valid = _ranked(s.reshape(N * Cp, M), score_threshold,
                               nms_top_k)
    K = vals.shape[1]
    img = torch.arange(N, device=s.device).repeat_interleave(Cp)[:, None]
    boxes = bboxes[img, idx]
    decay = torch.ones_like(vals)
    step = max(1, _NMS_BUDGET // max(1, K * K * boxes.element_size()))
    upper = torch.ones(K, K, dtype=torch.bool, device=s.device).triu(1)
    for a in range(0, N * Cp if K else 0, step):
        iou = torch.where(upper, _pair_iou(boxes[a:a + step]), 0)
        mx = iou.amax(1)[:, :, None]                      # row i's max
        if use_gaussian:
            d = torch.exp(-(iou * iou - mx * mx) / _k(iou, gaussian_sigma))
        else:
            d = (1 - iou) / torch.maximum(1 - mx, _k(mx, 1e-10))
        d = torch.where(upper, d, _k(d, torch.inf)).amin(1)
        d[:, :1] = 1.0
        decay[a:a + step] = d
    ds = vals * torch.minimum(decay, _k(decay, 1.0))
    sel = valid & (ds > _k(ds, post_threshold))
    return _detections(N, cls, ds.reshape(N, Cp, K),
                       boxes.reshape(N, Cp, K, 4),
                       (img * M + idx).reshape(N, Cp, K),
                       sel.reshape(N, Cp, K), keep_top_k)


@torch.no_grad()
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None):
    """Route RoIs to FPN levels on their device (reference ``:547-565``):
    ``floor(refer_level + log2(sqrt(area) / refer_scale))``, the area
    clipped at 1e-12, the level clipped to [min_level, max_level].
    Returns (the RoIs of each level in input order, restore_index (R,)
    int64, rois_num (levels,) int32); one read back (the level counts).
    ``rois_num`` is read by nothing, as in the reference."""
    r = fpn_rois
    area = (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])
    area = torch.maximum(area, _k(area, 1e-12))
    lvl = torch.floor(refer_level + torch.log2(_div(torch.sqrt(area),
                                                    refer_scale)))
    lvl = lvl.clamp(min_level, max_level).long()
    order = torch.sort(lvl, stable=True).indices
    nums = torch.bincount(lvl - min_level, minlength=max_level - min_level
                          + 1)
    restore = torch.empty_like(order)
    restore[order] = torch.arange(len(order), device=r.device)
    multi = list(torch.split(r[order], nums.tolist()))
    return multi, restore, nums.to(torch.int32)


@torch.no_grad()
def collect_fpn_proposals(multi_rois, multi_scores, post_nms_top_n):
    """The global top ``post_nms_top_n`` by score of every level's RoIs
    (reference ``:568-575``; no split by image), ranked by a stable sort."""
    rois = torch.cat(list(multi_rois), 0)
    scores = torch.cat([s.reshape(-1) for s in multi_scores], 0)
    top = torch.sort(scores, descending=True, stable=True).indices
    return rois[top[:post_nms_top_n]]


@torch.no_grad()
def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False):
    """RPN proposals of every image on the inputs' device (reference
    ``:578-625``), the images the groups of one NMS scan: ``scores`` (N, A,
    H, W) ranked over (H, W, A), the top ``pre_nms_top_n`` decoded from
    ``bbox_deltas`` (N, 4A, H, W) against ``anchors`` / ``variances`` (H,
    W, A, 4) (``exp(min(d, 10))``), clipped to [0, w - 1] x [0, h - 1] of
    ``im_shape`` (N, 2) = (h, w), those narrower or lower than
    ``min_size`` dropped, greedy NMS to ``post_nms_top_n``.  ``eta`` is
    accepted and ignored: the reference does not pass it on.  Returns f32
    (rois (R, 4), scores (R,)) and with ``return_rois_num`` rois_num (N,)
    int32; one read back (the kept mask)."""
    N, A, H, W = scores.shape
    s = scores.permute(0, 2, 3, 1).reshape(N, -1)
    d = bbox_deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(
        N, -1, 4)
    an = anchors.reshape(-1, 4)
    va = variances.reshape(-1, 4)
    vals, order = torch.sort(s, dim=-1, descending=True, stable=True)
    vals, order = vals[:, :pre_nms_top_n], order[:, :pre_nms_top_n]
    d = d.gather(1, order[..., None].expand(-1, -1, 4))
    a, v = an[order], va[order]
    pw = a[..., 2] - a[..., 0]
    ph = a[..., 3] - a[..., 1]
    pcx = a[..., 0] + pw / 2
    pcy = a[..., 1] + ph / 2
    dv = d * v
    cx = dv[..., 0] * pw + pcx
    cy = dv[..., 1] * ph + pcy
    bw = torch.exp(dv[..., 2].clamp(max=10)) * pw
    bh = torch.exp(dv[..., 3].clamp(max=10)) * ph
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        -1)
    hw = _const(im_shape, boxes).to(torch.float64).reshape(N, 2)
    hi = torch.stack([hw[:, 1], hw[:, 0]] * 2, -1) - 1     # (N, 4)
    boxes = torch.minimum(boxes.clamp(min=0), hi.to(boxes.dtype)[:, None])
    ms = _k(boxes, min_size)
    ok = (boxes[..., 2] - boxes[..., 0] >= ms) & (
        boxes[..., 3] - boxes[..., 1] >= ms)
    keep = _cap(_greedy_keep(boxes, ok, nms_thresh), post_nms_top_n)
    rois = boxes[keep].to(torch.float32)
    out = (rois, vals[keep].to(torch.float32))
    if return_rois_num:
        return out + (keep.sum(1).to(torch.int32),)
    return out


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


@torch.no_grad()
def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0.0):
    """Each prior's target from its matched gt row on the inputs' device
    (reference ``:954-977``): ``input`` (N, M, K), ``matched_indices`` (N,
    P), -1 where unmatched.  Returns (out (N, P, K) in the input's dtype,
    ``mismatch_value`` where unmatched; out_weight (N, P, 1) f32, 1 where
    matched and at each sample's ``negative_indices``)."""
    mi = matched_indices.to(input.device).long()
    N = mi.shape[0]
    pos = mi >= 0
    n = torch.arange(N, device=mi.device)[:, None]
    got = input[n, mi.clamp(min=0)]
    out = torch.where(pos[..., None], got,
                      got.new_full((), mismatch_value))
    w = pos.to(torch.float32)
    if negative_indices is not None:
        for i, neg in enumerate(negative_indices):
            w[i].index_fill_(0, _const(neg, w).long(), 1.0)
    return out, w[..., None]


@torch.no_grad()
def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0,
                       sample_size=None, mining_type="max_negative"):
    """Hard-negative mining on the inputs' device (reference ``:980-1002``):
    each sample keeps its unmatched priors of highest loss (a stable sort;
    ties in prior order), at most ``int(neg_pos_ratio * max(#pos, 1))`` of
    them (``sample_size`` for ``hard_example``), returned sorted; one read
    back (the counts).  Returns (the per-sample int64 index tensors,
    match_indices unchanged as int64), as the reference does whatever its
    docstring says."""
    if mining_type not in ("max_negative", "hard_example"):
        raise ValueError(f"unknown mining_type {mining_type}")
    mi = match_indices.to(cls_loss.device).long().clone()
    neg = mi < 0
    by_loss = torch.sort(cls_loss, dim=-1, descending=True,
                         stable=True).indices
    first = torch.sort((~neg.gather(1, by_loss)).to(torch.uint8), dim=-1,
                       stable=True).indices
    order = by_loss.gather(1, first)          # negatives first, by loss
    counts = torch.stack([neg.sum(1), (~neg).sum(1)], 1).tolist()
    lists = []
    for n, (n_neg, n_pos) in enumerate(counts):
        if mining_type == "max_negative":
            cap = int(neg_pos_ratio * max(n_pos, 1))
        else:
            cap = int(sample_size or n_neg)
        lists.append(torch.sort(order[n, :min(cap, n_neg)]).values)
    return lists, mi


@amp_op("box_decoder_and_assign")
def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip_value=4.135):
    """Decode per-class deltas ``target_box`` (N, 4 C) against RoIs
    ``prior_box`` (N, 4) with ``prior_box_var`` (N, 4) in the +1 pixel
    convention (``w = x2 - x1 + 1``, the far corner less 1; ``exp(min(d,
    box_clip_value))``), and give each RoI the box of its best class by
    ``box_score`` (N, C), background included (reference ``:1005-1033``).
    Returns (decoded (N, 4 C), assigned (N, 4)); gradients reach every
    input as in the reference, none through the argmax."""
    pb, pbv, tb, sc = prior_box, prior_box_var, target_box, box_score
    N, C = sc.shape
    pw = pb[:, 2] - pb[:, 0] + 1.0
    ph = pb[:, 3] - pb[:, 1] + 1.0
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5
    d = tb.reshape(N, C, 4) * pbv[:, None, :]
    dcx = d[..., 0] * pw[:, None] + pcx[:, None]
    dcy = d[..., 1] * ph[:, None] + pcy[:, None]
    dw = torch.exp(_min(d[..., 2], box_clip_value)) * pw[:, None]
    dh = torch.exp(_min(d[..., 3], box_clip_value)) * ph[:, None]
    boxes = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                         dcx + dw * 0.5 - 1.0, dcy + dh * 0.5 - 1.0], -1)
    best = torch.argmax(sc.detach(), 1)
    assigned = boxes.gather(1, best[:, None, None].expand(-1, 1, 4))[:, 0]
    return boxes.reshape(N, 4 * C), assigned


@torch.no_grad()
def locality_aware_nms(bboxes, scores, score_threshold=0.05, nms_top_k=-1,
                       keep_top_k=-1, nms_threshold=0.3, normalized=True):
    """EAST's locality-aware NMS (reference ``:1036-1076``): the boxes
    above ``score_threshold`` merged in input order, each into the last
    merged box where their IoU is above ``nms_threshold`` (score-weighted
    corners, summed scores), as the reference's host numpy, copied (one
    read back of ``bboxes`` and ``scores``); then on their device the top
    ``nms_top_k`` and greedy NMS to ``keep_top_k``.  Returns (K, 5)
    [score, x1, y1, x2, y2]."""
    dev = bboxes.device
    b = np.array(_host(bboxes), np.float32, copy=True)
    s = np.array(_host(scores), np.float32, copy=True).reshape(-1)
    keep = s > score_threshold
    b, s = b[keep], s[keep]

    def iou(a, c):
        lt = np.maximum(a[:2], c[:2])
        rb = np.minimum(a[2:], c[2:])
        wh = np.clip(rb - lt, 0, None)
        i = wh[0] * wh[1]
        aa = (a[2] - a[0]) * (a[3] - a[1])
        ac = (c[2] - c[0]) * (c[3] - c[1])
        return i / max(aa + ac - i, 1e-10)

    merged_b, merged_s = [], []
    for i in range(len(b)):
        if merged_b and iou(merged_b[-1], b[i]) > nms_threshold:
            w1, w2 = merged_s[-1], s[i]
            merged_b[-1] = (merged_b[-1] * w1 + b[i] * w2) / (w1 + w2)
            merged_s[-1] = w1 + w2
        else:
            merged_b.append(b[i].copy())
            merged_s.append(float(s[i]))
    if not merged_b:
        return torch.zeros(0, 5, dtype=torch.float32, device=dev)
    mb = _const(np.stack(merged_b), bboxes)
    ms = _const(np.asarray(merged_s, np.float32), bboxes)
    if nms_top_k > 0 and len(ms) > nms_top_k:
        top = torch.sort(ms, descending=True, stable=True).indices[:nms_top_k]
        mb, ms = mb[top], ms[top]
    kept = _nms_keep(mb, ms, nms_threshold, top_k=keep_top_k)
    return torch.cat([ms[kept, None], mb[kept]], 1)


def _iou_t(a, b):
    """The target stages' IoU matrix (reference ``_iou_np`` ``:1091``):
    areas clamped at 0, inter / max(area_a + area_b - inter, 1e-10)."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(
        min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(
        min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    den = area_a[:, None] + area_b[None] - inter
    return inter / torch.maximum(den, _k(den, 1e-10))


def _encode_t(anchors, gt, weights=(1.0, 1.0, 1.0, 1.0)):
    """Centre-size deltas of ``gt`` against ``anchors``, f32, no +1
    (reference ``_encode_np`` ``:1104``; ``box_decoder_and_assign`` decodes
    with +1: the reference's inconsistency, kept)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + aw * 0.5
    acy = anchors[:, 1] + ah * 0.5
    gw = gt[:, 2] - gt[:, 0]
    gh = gt[:, 3] - gt[:, 1]
    gcx = gt[:, 0] + gw * 0.5
    gcy = gt[:, 1] + gh * 0.5
    wx, wy, ww, wh = weights
    eps = _k(aw, 1e-10)
    return torch.stack([
        wx * (gcx - acx) / torch.maximum(aw, eps),
        wy * (gcy - acy) / torch.maximum(ah, eps),
        ww * torch.log(torch.maximum(gw, eps) / torch.maximum(aw, eps)),
        wh * torch.log(torch.maximum(gh, eps) / torch.maximum(ah, eps))],
        1).to(torch.float32)


def _assign_anchors(anchors, gt, pos_overlap, neg_overlap, crowd=None,
                    rows=None):
    """Labels (A,) int64 (1 fg, 0 bg, -1 ignored) and each anchor's matched
    gt (A,) int64 on the anchors' device (reference ``:1123-1145``): fg at
    IoU >= ``pos_overlap``, bg below ``neg_overlap``, and every gt's best
    anchor (its first maximum) force-matched, the last gt winning an anchor
    two claim.  Crowd gts (``crowd`` (G,) bool) are left out as if
    removed; anchors outside ``rows`` (A,) bool are ignored (-1) and claim
    nothing.  No gt: every anchor in ``rows`` is background."""
    A, G = len(anchors), len(gt)
    dev = anchors.device
    inside = rows if rows is not None else torch.ones(A, dtype=torch.bool,
                                                      device=dev)
    if G == 0:
        labels = torch.where(inside, 0, -1).long()
        return labels, torch.zeros(A, dtype=torch.long, device=dev)
    iou = _iou_t(anchors, gt)
    minus = _k(iou, -1.0)
    if crowd is not None:
        iou = torch.where(crowd[None], minus, iou)
    if rows is not None:
        iou = torch.where(rows[:, None], iou, minus)
    best_gt = torch.argmax(iou, 1)
    best = iou.gather(1, best_gt[:, None])[:, 0]
    labels = torch.full((A,), -1, dtype=torch.long, device=dev)
    labels = torch.where(best < _k(best, neg_overlap), 0, labels)
    labels = torch.where(best >= _k(best, pos_overlap), 1, labels)
    gt_best = torch.argmax(iou, 0)
    real = (~crowd if crowd is not None
            else torch.ones(G, dtype=torch.bool, device=dev))
    claim = torch.full((A,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, gt_best, torch.where(real, torch.arange(G, device=dev), -1),
        "amax")
    labels = torch.where(claim >= 0, 1, labels)
    best_gt = torch.where(claim >= 0, claim, best_gt)
    return torch.where(inside, labels, -1), best_gt


def _gt_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _flags(x, like):
    """A per-image flag vector (is_crowd) as bool on ``like``'s device."""
    return _const(torch.as_tensor(x).reshape(-1), like).bool()


@torch.no_grad()
def rpn_target_assign(anchor_box, gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True, seed=0):
    """RPN anchor assignment and fg / bg sampling (reference
    ``:1148-1213``).  ``anchor_box`` (A, 4) shared by the batch,
    ``gt_boxes`` a list of per-image (G_i, 4), ``is_crowd`` a list of
    (G_i,) flags (crowd gts never match), ``im_info`` (N, >= 2) (h, w)
    for the straddle filter.  The IoU, the labels and the targets run on
    the anchors' device; the sampling is the reference's numpy on the host,
    one read back of the (N, A) labels: fg capped at ``batch *
    fg_fraction``, bg at the rest, by ``fg[n_fg:]`` with ``use_random=
    False`` or by ``np.random.default_rng(seed).choice(.., replace=False)``
    over the batch's images in order: the same generator, calls and order
    as the reference, so the samples are its own, index for index.
    Returns (loc_index, score_index (flat into N * A), tgt_bbox (f32),
    tgt_label, int32, bbox_inside_weight (ones, f32))."""
    anchors = anchor_box.to(torch.float32)
    dev = anchors.device
    gts = _gt_list(gt_boxes)
    A = len(anchors)
    rng = np.random.default_rng(seed)
    labels, matched, boxes = [], [], []
    for n, gt in enumerate(gts):
        gt = _const(gt, anchors).to(torch.float32).reshape(-1, 4)
        crowd = (_flags(is_crowd[n], anchors) if is_crowd is not None
                 else None)
        rows = None
        if im_info is not None and rpn_straddle_thresh >= 0:
            hw = _const(im_info, anchors).to(torch.float64).reshape(
                len(gts), -1)[n]
            t = rpn_straddle_thresh
            lo = _k(anchors, -t)
            rows = ((anchors[:, 0] >= lo) & (anchors[:, 1] >= lo)
                    & (anchors[:, 2] < (hw[1] + t).to(torch.float32))
                    & (anchors[:, 3] < (hw[0] + t).to(torch.float32)))
        lab, match = _assign_anchors(anchors, gt, rpn_positive_overlap,
                                     rpn_negative_overlap, crowd, rows)
        labels.append(lab.to(torch.int8))
        matched.append(match)
        boxes.append(gt)
    host = _host(torch.stack(labels)) if gts else np.zeros((0, A), np.int8)
    loc, score, tgt, tlab = [], [], [], []
    for n in range(len(gts)):
        lab = host[n].astype(np.int64)
        fg = np.nonzero(lab == 1)[0]
        bg = np.nonzero(lab == 0)[0]
        n_fg = min(int(rpn_batch_size_per_im * rpn_fg_fraction), len(fg))
        if len(fg) > n_fg:
            drop = (rng.choice(fg, len(fg) - n_fg, replace=False)
                    if use_random else fg[n_fg:])
            lab[drop] = -1
            fg = np.nonzero(lab == 1)[0]
        n_bg = min(rpn_batch_size_per_im - n_fg, len(bg))
        if len(bg) > n_bg:
            drop = (rng.choice(bg, len(bg) - n_bg, replace=False)
                    if use_random else bg[n_bg:])
            lab[drop] = -1
            bg = np.nonzero(lab == 0)[0]
        fg_t = _const(fg, anchors)
        sel = _const(np.concatenate([fg, bg]), anchors)
        loc.append(n * A + fg_t)
        score.append(n * A + sel)
        tgt.append(_encode_t(anchors[fg_t], boxes[n][matched[n][fg_t]])
                   if len(boxes[n]) else anchors.new_zeros(0, 4))
        tlab.append(torch.cat([torch.ones(len(fg), dtype=torch.int32,
                                          device=dev),
                               torch.zeros(len(bg), dtype=torch.int32,
                                           device=dev)]))
    loc = torch.cat(loc).to(torch.int32)
    return (loc, torch.cat(score).to(torch.int32), torch.cat(tgt),
            torch.cat(tlab),
            torch.ones(len(loc), 4, dtype=torch.float32, device=dev))


@torch.no_grad()
def retinanet_target_assign(anchor_box, gt_boxes, gt_labels, is_crowd=None,
                            positive_overlap=0.5, negative_overlap=0.4):
    """RetinaNet anchor assignment on the anchors' device (reference
    ``:1216-1259``): as ``rpn_target_assign`` without the straddle filter
    or sampling, class labels for fg (0 for bg) and ``fg_num = max(#fg,
    1)`` an image; one read back (the fg / bg counts).  Returns
    (loc_index, score_index, tgt_bbox, tgt_label, bbox_inside_weight,
    fg_num)."""
    anchors = anchor_box.to(torch.float32)
    dev = anchors.device
    gts = _gt_list(gt_boxes)
    gls = _gt_list(gt_labels) if isinstance(gt_boxes, (list, tuple)) else [
        gt_labels]
    A = len(anchors)
    orders, counts, made = [], [], []
    for n, (gt, gl) in enumerate(zip(gts, gls)):
        gt = _const(gt, anchors).to(torch.float32).reshape(-1, 4)
        gl = _const(gl, anchors).long().reshape(-1)
        crowd = (_flags(is_crowd[n], anchors) if is_crowd is not None
                 else None)
        lab, match = _assign_anchors(anchors, gt, positive_overlap,
                                     negative_overlap, crowd)
        kind = torch.where(lab == 1, 0, torch.where(lab == 0, 1, 2))
        orders.append(torch.sort(kind.to(torch.uint8), stable=True).indices)
        counts.append(torch.stack([(lab == 1).sum(), (lab == 0).sum()]))
        made.append((gt, gl, match))
    counts = torch.stack(counts).tolist() if gts else []
    loc, score, tgt, tlab, fg_num = [], [], [], [], []
    for n, ((n_fg, n_bg), order, (gt, gl, match)) in enumerate(
            zip(counts, orders, made)):
        fg, sel = order[:n_fg], order[:n_fg + n_bg]
        loc.append(n * A + fg)
        score.append(n * A + sel)
        tgt.append(_encode_t(anchors[fg], gt[match[fg]]) if len(gt)
                   else anchors.new_zeros(0, 4))
        lab = torch.zeros(len(sel), dtype=torch.int32, device=dev)
        if len(gt):
            lab[:n_fg] = gl[match[fg]].to(torch.int32)
        tlab.append(lab)
        fg_num.append(max(n_fg, 1))
    loc = torch.cat(loc).to(torch.int32)
    return (loc, torch.cat(score).to(torch.int32), torch.cat(tgt),
            torch.cat(tlab),
            torch.ones(len(loc), 4, dtype=torch.float32, device=dev),
            _const(np.asarray(fg_num, np.int32), anchors))


@torch.no_grad()
def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=True,
                             is_cls_agnostic=False, seed=0):
    """Fast R-CNN RoI sampling and head targets (reference
    ``:1262-1334``); per-image lists.  The non-crowd gts join each image's
    proposals; the IoU, labels and targets run on the RoIs' device, and the
    sampling is the reference's numpy on the host, one read back an image
    (fg at max IoU >= ``fg_thresh``, bg in [lo, hi)): ``fg[:n]`` with
    ``use_random=False``, else ``np.random.default_rng(seed).choice(..,
    replace=False)`` over the images in order, the reference's own draws
    and order, index for index.  ``is_crowd`` is read on the host.
    Returns (rois f32, labels_int32, bbox_targets (S, 4 C) f32 divided by
    ``bbox_reg_weights`` at the label's slot (slot 1 of 2 with
    ``is_cls_agnostic``), bbox_inside_weights, bbox_outside_weights
    (inside > 0), rois_num (N,) int32)."""
    if not isinstance(rpn_rois, (list, tuple)):
        rpn_rois, gt_classes = [rpn_rois], [gt_classes]
        is_crowd, gt_boxes = [is_crowd], [gt_boxes]
    dev = rpn_rois[0].device
    rng = np.random.default_rng(seed)
    C = 2 if is_cls_agnostic else class_nums
    rois_o, labels_o, tgt_o, inw_o, nums = [], [], [], [], []
    for n in range(len(rpn_rois)):
        rois = rpn_rois[n].to(torch.float32).reshape(-1, 4)
        keep = _const(np.nonzero(~_host(is_crowd[n]).astype(bool).reshape(
            -1))[0], rois)
        gcls = _const(gt_classes[n], rois).long().reshape(-1)[keep]
        gt = _const(gt_boxes[n], rois).to(torch.float32).reshape(-1, 4)[keep]
        G = len(gt)
        cand = torch.cat([rois, gt], 0) if G else rois
        if G:
            iou = _iou_t(cand, gt)
            argm = torch.argmax(iou, 1)
            max_iou = iou.gather(1, argm[:, None])[:, 0]
        else:
            max_iou = cand.new_zeros(len(cand))
            argm = torch.zeros(len(cand), dtype=torch.long, device=dev)
        code = ((max_iou >= _k(max_iou, fg_thresh)).to(torch.uint8)
                + 2 * ((max_iou < _k(max_iou, bg_thresh_hi))
                       & (max_iou >= _k(max_iou, bg_thresh_lo))).to(
                           torch.uint8))
        code = _host(code)
        fg = np.nonzero(code & 1)[0]
        bg = np.nonzero(code & 2)[0]
        n_fg = min(int(batch_size_per_im * fg_fraction), len(fg))
        if len(fg) > n_fg:
            fg = (rng.choice(fg, n_fg, replace=False) if use_random
                  else fg[:n_fg])
        n_bg = min(batch_size_per_im - n_fg, len(bg))
        if len(bg) > n_bg:
            bg = (rng.choice(bg, n_bg, replace=False) if use_random
                  else bg[:n_bg])
        sel = _const(np.concatenate([fg, bg]).astype(np.int64), rois)
        S, F = len(sel), len(fg)
        labels = torch.zeros(S, dtype=torch.long, device=dev)
        tgts = rois.new_zeros(S, C, 4)
        inw = rois.new_zeros(S, C, 4)
        if F and G:
            fg_t = sel[:F]
            labels[:F] = gcls[argm[fg_t]]
            enc = _encode_t(cand[fg_t], gt[argm[fg_t]]) / _const(
                np.asarray(bbox_reg_weights, np.float32), rois)
            slot = (torch.ones(F, dtype=torch.long, device=dev)
                    if is_cls_agnostic else labels[:F])
            rows = torch.arange(F, device=dev)
            tgts[rows, slot] = enc
            inw[rows, slot] = 1.0
        rois_o.append(cand[sel])
        labels_o.append(labels)
        tgt_o.append(tgts.reshape(S, 4 * C))
        inw_o.append(inw.reshape(S, 4 * C))
        nums.append(S)
    inw = torch.cat(inw_o)
    return (torch.cat(rois_o), torch.cat(labels_o).to(torch.int32),
            torch.cat(tgt_o), inw, (inw > 0).to(torch.float32),
            _const(np.asarray(nums, np.int32), rpn_rois[0]))


def _rasterize_polygons(polys, box, M):
    """Even-odd rasterisation of polygons (lists of (K, 2) xy arrays) at
    the centres of an M x M grid over ``box`` (x1, y1, x2, y2): the
    reference's host numpy (``:1337-1357``), copied."""
    x1, y1, x2, y2 = [float(v) for v in box]
    xs = x1 + (np.arange(M) + 0.5) * max(x2 - x1, 1e-6) / M
    ys = y1 + (np.arange(M) + 0.5) * max(y2 - y1, 1e-6) / M
    gx, gy = np.meshgrid(xs, ys)
    inside = np.zeros((M, M), bool)
    for poly in polys:
        p = np.asarray(poly, np.float32).reshape(-1, 2)
        cnt = np.zeros((M, M), np.int32)
        for i in range(len(p)):
            x0, y0 = p[i]
            x1e, y1e = p[(i + 1) % len(p)]
            cond = ((y0 <= gy) != (y1e <= gy))
            with np.errstate(divide="ignore", invalid="ignore"):
                xi = x0 + (gy - y0) * (x1e - x0) / (y1e - y0)
            cnt += (cond & (gx < xi)).astype(np.int32)
        inside |= (cnt % 2).astype(bool)
    return inside.astype(np.int32)


@torch.no_grad()
def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, rois_num=None, num_classes=81,
                         resolution=14):
    """Mask R-CNN mask targets (reference ``:1360-1418``); per-image lists,
    ``gt_segms[n][g]`` a list of (K, 2) polygons.  Each foreground RoI
    takes the gt of its own class (all gts where none is) of highest IoU
    with it (the first maximum), the IoU on the RoIs' device; that gt's
    polygons are rasterised inside the RoI on the host (the reference's
    numpy, one read back an image) and packed on the device at the RoI's
    class offset, -1 elsewhere.  gt boxes are the polygons' extents.
    Returns (mask_rois (R, 4) f32, roi_has_mask_int32 (R,), mask_int32 (R,
    num_classes * resolution^2))."""
    if not isinstance(rois, (list, tuple)):
        rois, gt_classes = [rois], [gt_classes]
        is_crowd, gt_segms = [is_crowd], [gt_segms]
        labels_int32 = [labels_int32]
    M = resolution
    dev = rois[0].device
    out_rois, out_mask = [], []
    for n in range(len(rois)):
        r = rois[n].to(torch.float32).reshape(-1, 4)
        lab = labels_int32[n].to(dev).long().reshape(-1)
        crowd = _host(is_crowd[n]).astype(bool).reshape(-1)
        gcls = _host(gt_classes[n]).astype(np.int64).reshape(-1)
        segs = [s for s, c in zip(gt_segms[n], crowd) if not c]
        gcls = gcls[~crowd]
        gboxes = []
        for polys in segs:
            pts = np.concatenate([np.asarray(p, np.float32).reshape(-1, 2)
                                  for p in polys], 0)
            gboxes.append([pts[:, 0].min(), pts[:, 1].min(),
                           pts[:, 0].max(), pts[:, 1].max()])
        gboxes = np.asarray(gboxes, np.float32).reshape(-1, 4)
        if len(gboxes):
            iou = _iou_t(r, _const(gboxes, r))
            same = lab[:, None] == _const(gcls, r)[None]
            pool = torch.where(same.any(1, keepdim=True), same, True)
            gi = torch.argmax(torch.where(pool, iou, _k(iou, -torch.inf)), 1)
        else:
            gi = torch.zeros(len(r), dtype=torch.long, device=dev)
        host = _host(torch.cat([r.double(), lab[:, None].double(),
                                gi[:, None].double()], 1))
        fg = np.nonzero(host[:, 4] > 0)[0]
        masks = np.zeros((len(fg), M, M), np.int32)
        if len(gboxes):
            for k, i in enumerate(fg):
                masks[k] = _rasterize_polygons(
                    segs[int(host[i, 5])], host[i, :4].astype(np.float32), M)
        fg_t = _const(fg, r)
        packed = torch.full((len(fg), num_classes, M * M), -1,
                            dtype=torch.int32, device=dev)
        packed[torch.arange(len(fg), device=dev), lab[fg_t]] = _const(
            masks.reshape(len(fg), M * M), r)
        out_rois.append(r[fg_t])
        out_mask.append(packed.reshape(len(fg), num_classes * M * M))
    mask_rois = torch.cat(out_rois)
    return (mask_rois, torch.ones(len(mask_rois), dtype=torch.int32,
                                  device=dev), torch.cat(out_mask))


@torch.no_grad()
def retinanet_detection_output(bboxes, scores, anchors, im_info=None,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.45,
                               nms_eta=1.0):
    """RetinaNet's multi-level decode and class-wise NMS on the inputs'
    device (reference ``:1421-1471``).  Per level ``bboxes[l]`` (A_l, 4)
    deltas, ``scores[l]`` (A_l, C) sigmoid scores, ``anchors[l]`` (A_l,
    4): the (anchor, class) pairs above ``score_threshold``, at most
    ``nms_top_k`` of the best a level, decoded without variances
    (``exp(min(d, 10))``), clipped to the first image of ``im_info`` (its
    ``reshape(-1)``, as the reference); then every class a group of one
    greedy scan with ``nms_eta``, the kept rows ordered by score (a stable
    sort over (class, rank) order) and cut to ``keep_top_k``.  Returns (D,
    6) [label, score, x1, y1, x2, y2] f32; two reads back (the largest
    class's count, the kept mask)."""
    cand_b, cand_s, cand_c = [], [], []
    for bb, sc, an in zip(bboxes, scores, anchors):
        bb = bb.to(torch.float32).reshape(-1, 4)
        sc = sc.to(torch.float32)
        an = an.to(torch.float32).reshape(-1, 4)
        C = sc.shape[1]
        vals, ok = torch.sort(sc.reshape(-1), descending=True, stable=True)
        if nms_top_k > 0:
            vals, ok = vals[:nms_top_k], ok[:nms_top_k]
        ai, ci = ok // C, ok % C
        aw = an[ai, 2] - an[ai, 0]
        ah = an[ai, 3] - an[ai, 1]
        acx = an[ai, 0] + aw * 0.5
        acy = an[ai, 1] + ah * 0.5
        d = bb[ai]
        cx = d[:, 0] * aw + acx
        cy = d[:, 1] * ah + acy
        w = torch.exp(d[:, 2].clamp(max=10)) * aw
        h = torch.exp(d[:, 3].clamp(max=10)) * ah
        box = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                          1)
        if im_info is not None:
            hw = _const(im_info, box).to(torch.float64).reshape(-1)
            hi = (torch.stack([hw[1], hw[0]] * 2) - 1).to(torch.float32)
            box = torch.minimum(box.clamp(min=0), hi)
        cand_b.append(box)
        cand_s.append(torch.where(vals > _k(vals, score_threshold), vals,
                                  _k(vals, -torch.inf)))
        cand_c.append(ci)
    if not cand_b:
        return torch.zeros(0, 6, dtype=torch.float32)
    b = torch.cat(cand_b)
    s = torch.cat(cand_s)
    c = torch.cat(cand_c)
    dev = b.device
    C = int(scores[0].shape[1])
    valid = s > -torch.inf
    # candidates by class, each class best first (stable: candidate order)
    by_s = torch.sort(s, descending=True, stable=True).indices
    key = torch.where(valid, c, C)[by_s]
    order = by_s[torch.sort(key, stable=True).indices]
    key = torch.where(valid, c, C)[order]
    counts = torch.bincount(key, minlength=C + 1)[:C]
    K = int(counts.max()) if len(order) else 0
    start = torch.cumsum(counts, 0) - counts
    ranked = valid[order]
    rank = torch.arange(len(order), device=dev) - start[key.clamp(max=C - 1)]
    # the candidates past the classes go to a spare row, dropped
    slot = torch.full((C + 1, max(K, 1)), -1, dtype=torch.long, device=dev)
    slot[torch.where(ranked, key, C), torch.where(ranked, rank, 0)] = order
    slot = slot[:C, :K]
    has = slot >= 0
    pick = slot.clamp(min=0)
    keep = _greedy_keep(b[pick], has, nms_threshold, nms_eta)
    out, _, _ = _detections(1, torch.arange(C), s[pick][None],
                            b[pick][None], pick[None], keep[None],
                            keep_top_k)
    return out


@amp_op("roi_perspective_transform")
def roi_perspective_transform(x, rois, transformed_height, transformed_width,
                              spatial_scale=1.0, boxes_num=None):
    """Warp quadrilateral RoIs (R, 8) (x1, y1, ..., x4, y4, clockwise from
    the top left, input scale) of x (N, C, H, W) to (R, C, th, tw)
    (reference ``:1474-1549``): each RoI's homography from the output
    grid's corners, solved in f64 on the host (one read back of ``rois``)
    and cast to f32, then bilinear samples on the device (the floor
    clipped to the map, the weights clipped to [0, 1]), zero where the
    source lies outside the map.  Differentiable in ``x`` only.
    ``boxes_num`` [N] assigns RoIs to images and is required when N >
    1."""
    th, tw = int(transformed_height), int(transformed_width)
    rois_np = np.asarray(_host(rois), np.float32).reshape(-1, 8)
    N, C, H, W = x.shape
    if boxes_num is None and N != 1:
        raise ValueError(
            "roi_perspective_transform: pass boxes_num to assign rois to "
            f"batch images (x has {N} images)")
    R = len(rois_np)
    img = _roi_image_index(boxes_num, R, x)
    mats = []
    dst = np.asarray([[0, 0], [tw - 1, 0], [tw - 1, th - 1], [0, th - 1]],
                     np.float64)
    for q in rois_np * spatial_scale:
        src = q.reshape(4, 2).astype(np.float64)
        Amat, bvec = [], []
        for (xd, yd), (xs, ys) in zip(dst, src):
            Amat.append([xd, yd, 1, 0, 0, 0, -xs * xd, -xs * yd])
            Amat.append([0, 0, 0, xd, yd, 1, -ys * xd, -ys * yd])
            bvec += [xs, ys]
        h8 = np.linalg.solve(np.asarray(Amat), np.asarray(bvec))
        mats.append(np.append(h8, 1.0).reshape(3, 3))
    Hm = _const(np.stack(mats).astype(np.float32).reshape(R, 3, 3)
                if R else np.zeros((0, 3, 3), np.float32), x)
    gy, gx = torch.meshgrid(torch.arange(th, dtype=torch.float32,
                                         device=x.device),
                            torch.arange(tw, dtype=torch.float32,
                                         device=x.device), indexing="ij")
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1).double()
    Hd = Hm.double()
    # (R, P) each, rounded as the reference's einsum on XLA's CPU rounds:
    # h0 gx, then two fused multiply-adds (the grid's integers make the
    # f64 products exact)
    src = [((Hm[:, i, 0:1] * gx).double() + Hd[:, i, 1:2] * gy).float()
           .double().add(Hd[:, i, 2:3]).float() for i in range(3)]
    den = torch.maximum(src[2], _k(src[2], 1e-8))
    sx, sy = src[0] / den, src[1] / den
    x0 = torch.floor(sx).clamp(0, W - 1)
    y0 = torch.floor(sy).clamp(0, H - 1)
    x1i = (x0 + 1).clamp(max=W - 1).long()
    y1i = (y0 + 1).clamp(max=H - 1).long()
    wx = _clip(sx - x0, 0.0, 1.0)[..., None]
    wy = _clip(sy - y0, 0.0, 1.0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    xf = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    base = img[:, None] * (H * W)

    def at(yi, xi):                                       # (R, P, C)
        return xf.index_select(0, (base + yi * W + xi).reshape(-1)).reshape(
            R, -1, C)
    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    valid = ((sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1))
    out = out * valid[..., None]
    return out.permute(0, 2, 1).reshape(R, C, th, tw)


__all__ += ["nms", "bipartite_match", "multiclass_nms", "matrix_nms",
            "distribute_fpn_proposals", "collect_fpn_proposals",
            "generate_proposals", "target_assign", "mine_hard_examples",
            "box_decoder_and_assign", "locality_aware_nms",
            "rpn_target_assign", "retinanet_target_assign",
            "generate_proposal_labels", "generate_mask_labels",
            "retinanet_detection_output", "roi_perspective_transform"]
