"""Shared pieces of the Faster R-CNN tests: a tiny two-stage detector of
public layers and ``vision.ops``, the same in both packages, and its
training loss.  The JAX package has no detector class, so neither does
the port: the full one (ResNet-50, FPN P2-P6 of 256 channels,
PaddleDetection's ``faster_rcnn_r50_fpn_1x_coco``) lives in
``chip_smoke.py`` (``faster_rcnn_fpn``).  Weights carry from the reference
to the port by name (``models.load_named_params``).

- Three 3x3 stride-2 convolutions (3 -> 8 -> 16 -> 16, ReLU) take a 64x64
  image to C2 (stride 4) and C3 (stride 8); an FPN of 16 channels (1x1
  laterals, nearest x2 top-down, 3x3 outputs) gives P2 and P3.
- The RPN head (a shared 3x3 convolution and ReLU, then 1x1 to 3
  objectness logits and 12 deltas) over anchors of 16 and 32 pixels,
  ratios 0.5, 1, 2; ``rpn_target_assign`` (32 an image, fg 0.5), the
  proposals of each level (``generate_proposals``, pre 50 / post 20, NMS
  0.7), ``collect_fpn_proposals`` to 30 an image, ``generate_proposal_labels``
  (16 an image, fg 0.25, 5 classes with the background),
  ``distribute_fpn_proposals`` to P2-P3 and ``roi_align`` 4x4 at each.
- The RoI head: two FC of 32 (ReLU) to 5 logits and 20 deltas.
- The loss: sigmoid BCE on the sampled anchors, smooth L1 on the fg
  anchors' deltas over the sample's size, softmax CE over the sampled
  RoIs, smooth L1 on the fg class slots (``bbox_inside_weights``) over
  the RoIs' count; summed.

``pkg`` is each package's namespace for the few tensor calls the
composition needs: ``nn``, ``F``, ``ops``, ``gather(x, index)``
(``paddle_tpu.gather`` in the reference, indexing in the port), ``concat``,
``transpose``, ``reshape``, ``cast`` and ``host`` (a tensor as numpy)."""
import numpy as np

HW, CLASSES = 64, 5                  # classes with the background
STRIDES, SIZES = (4, 8), (16.0, 32.0)
RATIOS = (0.5, 1.0, 2.0)
RPN_BATCH, PRE, POST, COLLECT = 32, 50, 20, 30
ROI_BATCH, ROI = 16, 4
REG_W = (0.1, 0.1, 0.2, 0.2)


def detector(nn, F, width=16, fc=32, **kw):
    """The tiny detector of ``nn`` and ``F`` (its functional); ``kw`` goes
    to every layer (the port's ``device``).  forward(x) returns the RPN's
    (logits, deltas) of P2 and P3 and the two maps."""
    A = len(RATIOS)

    class TinyFasterRCNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2D(3, 8, 3, stride=2, padding=1, **kw)
            self.conv2 = nn.Conv2D(8, width, 3, stride=2, padding=1, **kw)
            self.conv3 = nn.Conv2D(width, width, 3, stride=2, padding=1,
                                   **kw)
            self.lat2 = nn.Conv2D(width, width, 1, **kw)
            self.lat3 = nn.Conv2D(width, width, 1, **kw)
            self.out2 = nn.Conv2D(width, width, 3, padding=1, **kw)
            self.out3 = nn.Conv2D(width, width, 3, padding=1, **kw)
            self.rpn = nn.Conv2D(width, width, 3, padding=1, **kw)
            self.rpn_obj = nn.Conv2D(width, A, 1, **kw)
            self.rpn_reg = nn.Conv2D(width, 4 * A, 1, **kw)
            self.fc1 = nn.Linear(width * ROI * ROI, fc, **kw)
            self.fc2 = nn.Linear(fc, fc, **kw)
            self.cls = nn.Linear(fc, CLASSES, **kw)
            self.reg = nn.Linear(fc, 4 * CLASSES, **kw)

        def forward(self, x):
            c2 = F.relu(self.conv2(F.relu(self.conv1(x))))
            c3 = F.relu(self.conv3(c2))
            p3 = self.lat3(c3)
            p2 = self.lat2(c2) + F.interpolate(p3, scale_factor=2,
                                               mode="nearest")
            feats = [self.out2(p2), self.out3(p3)]
            heads = []
            for f in feats:
                h = F.relu(self.rpn(f))
                heads.append((self.rpn_obj(h), self.rpn_reg(h)))
            return heads, feats

        def roi_head(self, r):
            h = F.relu(self.fc2(F.relu(self.fc1(r))))
            return self.cls(h), self.reg(h)
    return TinyFasterRCNN()


def batch(n, seed=0, dtype=np.float32):
    """Images N(0, 1) and per image 3 gt boxes (xyxy pixels inside the
    image, classes 1-4), the first image's last one a crowd box; im_info
    (h, w, scale) rows."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 3, HW, HW)).astype(dtype)
    gts, classes, crowd = [], [], []
    for i in range(n):
        xy = r.uniform(0, HW - 24, (3, 2))
        wh = r.uniform(10, 24, (3, 2))
        gts.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
        classes.append(r.integers(1, CLASSES, 3).astype(np.int64))
        crowd.append(np.array([False, False, i == 0]))
    im_info = np.array([[HW, HW, 1.0]] * n, np.float32)
    return x, gts, classes, crowd, im_info


def anchors(ops, feats):
    """Each level's (H, W, A, 4) anchors and variances."""
    return [ops.anchor_generator(f, [s], list(RATIOS),
                                 stride=(float(st), float(st)))
            for f, s, st in zip(feats, SIZES, STRIDES)]


def losses(pkg, model, x, gts, classes, crowd, im_info, seed=0):
    """The training loss of ``model`` on one batch through ``pkg``.
    Returns (total, the named samples: score_index, loc_index, tgt_label,
    the sampled RoIs and their labels)."""
    F, ops, g = pkg["F"], pkg["ops"], pkg["gather"]
    cat, tr, rs, host = (pkg["concat"], pkg["transpose"], pkg["reshape"],
                         pkg["host"])
    n = len(gts)
    heads, feats = model(x)
    levels = anchors(ops, feats)
    an_all = cat([rs(a, [-1, 4]) for a, _ in levels], 0)
    logit = cat([rs(tr(o, [0, 2, 3, 1]), [n, -1]) for o, _ in heads], 1)
    delta = cat([rs(tr(rs(d, [n, len(RATIOS), 4] + list(d.shape[2:])),
                       [0, 3, 4, 1, 2]), [n, -1, 4]) for _, d in heads], 1)
    loc, score, tbox, tlab, _ = ops.rpn_target_assign(
        an_all, gts, crowd, im_info, RPN_BATCH, 0.0, 0.5, 0.7, 0.3,
        use_random=True, seed=seed)
    l_cls = F.binary_cross_entropy_with_logits(
        g(rs(logit, [-1]), score), pkg["cast"](tlab, "float32"))
    l_reg = F.smooth_l1_loss(g(rs(delta, [-1, 4]), loc), tbox,
                             reduction="sum") / max(len(host(score)), 1)
    per_level = []
    for (o, d), (a, v) in zip(heads, levels):
        rois, sc, num = ops.generate_proposals(
            F.sigmoid(o), d, im_info[:, :2], a, v, PRE, POST, 0.7, 0.0,
            return_rois_num=True)
        per_level.append((rois, sc, np.cumsum([0] + list(host(num)))))
    collected = [ops.collect_fpn_proposals(
        [r[c[i]:c[i + 1]] for r, _, c in per_level],
        [s[c[i]:c[i + 1]] for _, s, c in per_level], COLLECT)
        for i in range(n)]
    rois, labels, tgts, inw, _, nums = ops.generate_proposal_labels(
        collected, classes, crowd, gts, batch_size_per_im=ROI_BATCH,
        fg_fraction=0.25, fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
        bbox_reg_weights=REG_W, class_nums=CLASSES, use_random=True,
        seed=seed + 1)
    feat = roi_features(pkg, feats, rois, host(nums))
    cls, reg = model.roi_head(feat)
    l_rcnn = F.cross_entropy(cls, pkg["cast"](labels, "int64"))
    l_box = F.smooth_l1_loss(reg * inw, tgts * inw, reduction="sum") / len(
        host(labels))
    samples = {"score_index": score, "loc_index": loc, "tgt_label": tlab,
               "rois": rois, "labels": labels}
    return l_cls + l_reg + l_rcnn + l_box, samples


def roi_features(pkg, feats, rois, nums):
    """RoIAlign (ROI x ROI, aligned) of each image's RoIs at the level
    ``distribute_fpn_proposals`` routes them to (P2-P3, refer level 3 at
    32 pixels), all images of a level in one call with ``boxes_num``, the
    rows gathered back to the RoIs' order.  Returns (R, C * ROI^2)."""
    ops, cat, host = pkg["ops"], pkg["concat"], pkg["host"]
    starts = np.cumsum([0] + list(nums))
    per_img = []
    for i in range(len(nums)):
        multi, restore, lvl_num = ops.distribute_fpn_proposals(
            rois[starts[i]:starts[i + 1]], 2, 3, 3, 32)
        order = np.argsort(host(restore))
        per_img.append((multi, starts[i] + order,
                        np.cumsum([0] + list(host(lvl_num)))))
    out, src = [], []
    for lv, (f, st) in enumerate(zip(feats, STRIDES)):
        sizes = [int(c[lv + 1] - c[lv]) for _, _, c in per_img]
        if not sum(sizes):
            continue
        boxes = cat([m[lv] for m, _, _ in per_img], 0)
        out.append(ops.roi_align(f, boxes, np.asarray(sizes, np.int32), ROI,
                                 1.0 / st, aligned=True))
        src += [o[c[lv]:c[lv + 1]] for _, o, c in per_img]
    feat = cat(out, 0)
    perm = np.argsort(np.concatenate(src))
    feat = pkg["gather"](feat, pkg["index"](perm))
    return pkg["reshape"](feat, [len(perm), -1])
