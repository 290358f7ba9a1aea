"""Shared pieces of the YOLOv3 tests: a tiny detector of public layers,
the same in both packages, and its loss.  The JAX package has no detector
class, so neither does the port: the tiny model lives here and the full
one (ResNet-50 with DCNv2 in stage 5 and the YOLOv3 FPN head,
PaddleDetection's ``yolov3_r50vd_dcn_270e_coco`` at published widths) in
``chip_smoke.py`` (``yolov3_dcn``).  Weights carry from the reference to
the port by name (``models.load_named_params``).

- Three 3x3 stride-2 convolutions (3 -> 8 -> 16 -> 16 channels, LeakyReLU
  0.1) take a 64x64 image to C3 (stride 8, 8x8).
- C4 (stride 16, 4x4) is a DCNv2 block: a 3x3 stride-2 convolution
  making 27 channels (18 offsets, (dy, dx) a tap, and 9 sigmoid masks)
  and a ``DeformConv2D(16, 32, 3, stride=2, padding=1)`` on C3.
- Heads: a 1x1 convolution of C4 to 3 (5 + C) channels, and one of C3
  plus C4 routed by a 1x1 convolution to 16 channels and upsampled x2
  (nearest).
- The loss: ``yolo_loss`` at both scales (masks [[3, 4, 5], [0, 1, 2]] of
  six COCO anchors, downsample 16 and 8, ignore_thresh 0.7, no label
  smoothing), each averaged over the batch, summed."""
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
MASKS = [[3, 4, 5], [0, 1, 2]]
DOWNSAMPLE = [16, 8]
CLASSES = 4
IGNORE = 0.7


def detector(nn, F, ops, classes=CLASSES, **kw):
    """The tiny detector of ``nn``, ``F`` (its functional) and ``ops``
    (its ``vision.ops``); ``kw`` goes to every layer (the port's
    ``device``)."""
    out = 3 * (5 + classes)

    class TinyYolo(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2D(3, 8, 3, stride=2, padding=1, **kw)
            self.conv2 = nn.Conv2D(8, 16, 3, stride=2, padding=1, **kw)
            self.conv3 = nn.Conv2D(16, 16, 3, stride=2, padding=1, **kw)
            self.conv_offset = nn.Conv2D(16, 27, 3, stride=2, padding=1,
                                         **kw)
            self.dcn = ops.DeformConv2D(16, 32, 3, stride=2, padding=1, **kw)
            self.route = nn.Conv2D(32, 16, 1, **kw)
            self.head16 = nn.Conv2D(32, out, 1, **kw)
            self.head8 = nn.Conv2D(16, out, 1, **kw)

        def forward(self, x):
            act = lambda t: F.leaky_relu(t, 0.1)           # noqa: E731
            c3 = act(self.conv3(act(self.conv2(act(self.conv1(x))))))
            om = self.conv_offset(c3)
            c4 = act(self.dcn(c3, om[:, :18], F.sigmoid(om[:, 18:])))
            up = F.interpolate(act(self.route(c4)), scale_factor=2,
                               mode="nearest")
            return self.head16(c4), self.head8(c3 + up)
    return TinyYolo()


def loss(ops, outs, gt_box, gt_label):
    total = 0
    for o, m, d in zip(outs, MASKS, DOWNSAMPLE):
        total = total + ops.yolo_loss(o, gt_box, gt_label, ANCHORS, m,
                                      CLASSES, IGNORE, d,
                                      use_label_smooth=False).mean()
    return total
