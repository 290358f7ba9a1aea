"""The port's ``vision.ops`` (its dense half) against the reference's on
the CPU from the same numpy inputs: outputs, and the gradients of
sum(out * w) for a fixed random w with respect to every floating input.

The reference's gradient rules have cases of their own, each beside the
fault it rules out: ``roi_align`` at integer sample positions, where
``jnp.clip``'s tie halves the boxes' gradient (``clamp`` would not), and
``roi_pool`` on a saturating ReLU's map of zeros and ones, where two
reduce-maxes (rows, then columns) split a tied gradient 1 / (row ties) x
1 / (column ties) (one joint ``amax`` would give 1 / (all ties)).  The
priors and anchors are host numpy in both packages: bitwise.  Tolerance:
f32 values 1e-5, gradients 1e-4, absolute and relative."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.vision import ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-4)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _run(jfn, tfn, arrays, seed=11):
    """Both on the numpy ``arrays``; every output compared, then the
    gradients of sum(out_i * w_i) over the outputs for every f32 input.
    Returns (port outputs, port gradients, reference gradients)."""
    js = [paddle.to_tensor(a, stop_gradient=a.dtype != np.float32)
          for a in arrays]
    ts = [torch.from_numpy(a.copy()).requires_grad_(a.dtype == np.float32)
          for a in arrays]
    oj, ot = jfn(*js), tfn(*ts)
    oj = oj if isinstance(oj, tuple) else (oj,)
    ot = ot if isinstance(ot, tuple) else (ot,)
    lj = lt = 0
    for k, (j, t) in enumerate(zip(oj, ot)):
        want = np.asarray(j._data)
        assert tuple(t.shape) == want.shape, f"output {k} shape"
        np.testing.assert_allclose(t.detach().numpy(), want, **TOL,
                                   err_msg=f"output {k}")
        w = np.random.default_rng(seed + k).standard_normal(
            want.shape).astype(np.float32)
        lj = lj + (j * paddle.to_tensor(w)).sum()
        lt = lt + (t * torch.from_numpy(w)).sum()
    lj.backward()
    lt.backward()
    got, ref = [], []
    for i, (j, t) in enumerate(zip(js, ts)):
        if t.requires_grad:
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            want = (np.asarray(j.grad._data) if j.grad is not None
                    else np.zeros(t.shape, np.float32))
            np.testing.assert_allclose(g.numpy(), want, **TOL_GRAD,
                                       err_msg=f"gradient of input {i}")
            got.append(g.numpy())
            ref.append(want)
    return ot, got, ref


def _boxes(n, hw, seed, lo=1.0, hi=None):
    r = np.random.default_rng(seed)
    x1 = r.uniform(0, hw - 2, n)
    y1 = r.uniform(0, hw - 2, n)
    w = r.uniform(lo, hi or hw / 2, n)
    h = r.uniform(lo, hi or hw / 2, n)
    return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


# -- box utilities -------------------------------------------------------

def test_box_iou_matches_reference():
    _run(jops.box_iou, tops.box_iou, [_boxes(5, 16, 0), _boxes(4, 16, 1)])


@pytest.mark.parametrize("normalized", [True, False])
def test_iou_similarity_matches_reference(normalized):
    a, b = _boxes(5, 16, 2), _boxes(6, 16, 3)
    if normalized:
        a, b = a / 16, b / 16
    _run(lambda x, y: jops.iou_similarity(x, y, normalized),
         lambda x, y: tops.iou_similarity(x, y, normalized), [a, b])


@pytest.mark.parametrize("code_type", ["encode_center_size",
                                       "decode_center_size"])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_matches_reference(code_type, normalized):
    pb = _boxes(6, 32, 4, lo=2.0)
    if normalized:
        pb = pb / 32
    var = np.abs(_x(6, 4, seed=5)) * 0.1 + 0.1
    tb = (_boxes(6, 32, 6, lo=2.0) / (32 if normalized else 1)
          if code_type == "encode_center_size" else _x(6, 4, seed=7) * 0.5)
    _run(lambda p, v, t: jops.box_coder(p, v, t, code_type, normalized),
         lambda p, v, t: tops.box_coder(p, v, t, code_type, normalized),
         [pb, var, tb])


def test_box_clip_matches_reference_with_ties():
    """Coordinates beyond the image and exactly on its bounds (0 and
    w - 1): the tie halves the gradient there."""
    b = (_x(2, 5, 4, seed=8) * 12 + 6).astype(np.float32)
    b[0, 0] = [0.0, 0.0, 15.0, 11.0]
    im = np.array([[12, 16], [10, 9]], np.int32)
    _run(lambda x, s: jops.box_clip(x, s[:, None]),
         lambda x, s: tops.box_clip(x, s[:, None]), [b, im])


# -- priors and anchors: host numpy, bitwise -----------------------------

def _bitwise(jout, tout):
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j._data))
        assert t.dtype == torch.float32


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[30.0], max_sizes=[60.0], aspect_ratios=[2.0],
         flip=True, clip=True),
    dict(min_sizes=[20.0, 40.0], aspect_ratios=[1.0, 2.0, 3.0],
         steps=(8.0, 6.0), offset=0.25),
])
def test_prior_box_bitwise(kw):
    feat, img = np.zeros((1, 4, 5, 6), np.float32), np.zeros(
        (1, 3, 40, 48), np.float32)
    _bitwise(jops.prior_box(paddle.to_tensor(feat), paddle.to_tensor(img),
                            **kw),
             tops.prior_box(torch.from_numpy(feat), torch.from_numpy(img),
                            **kw))


def test_anchor_generator_bitwise():
    feat = np.zeros((1, 4, 5, 7), np.float32)
    kw = dict(anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0],
              stride=(16.0, 8.0), offset=0.5)
    _bitwise(jops.anchor_generator(paddle.to_tensor(feat), **kw),
             tops.anchor_generator(torch.from_numpy(feat), **kw))


@pytest.mark.parametrize("with_image", [True, False])
def test_density_prior_box_bitwise(with_image):
    feat, img = np.zeros((1, 4, 6, 5), np.float32), np.zeros(
        (1, 3, 48, 40), np.float32)
    kw = dict(densities=[4, 2], fixed_sizes=[32.0, 64.0],
              fixed_ratios=[1.0, 2.0], clip=True)
    _bitwise(jops.density_prior_box(
        paddle.to_tensor(feat), paddle.to_tensor(img) if with_image
        else None, **kw),
        tops.density_prior_box(torch.from_numpy(feat),
                               torch.from_numpy(img) if with_image else None,
                               **kw))


# -- yolo_box ------------------------------------------------------------

@pytest.mark.parametrize("clip_bbox,scale_x_y", [(True, 1.0), (False, 1.0),
                                                 (True, 1.05)])
def test_yolo_box_matches_reference(clip_bbox, scale_x_y):
    anchors, classes = [10, 13, 16, 30], 3
    x = _x(2, 2 * (5 + classes), 4, 5, seed=9, scale=2.0)
    img = np.array([[64, 80], [60, 70]], np.int32)
    out, _, _ = _run(
        lambda a, s: jops.yolo_box(a, s, anchors, classes, 0.3, 16,
                                   clip_bbox, scale_x_y),
        lambda a, s: tops.yolo_box(a, s, anchors, classes, 0.3, 16,
                                   clip_bbox, scale_x_y), [x, img])
    kept = (out[1].detach().abs().sum(-1) > 0)
    assert 0 < int(kept.sum()) < kept.numel()     # the threshold bites


# -- roi_align -----------------------------------------------------------

@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_two_images(aligned):
    x = _x(2, 3, 12, 10, seed=10)
    boxes = _boxes(5, 20, 11)
    boxes[4] = [-4.0, 15.0, 26.0, 30.0]           # reaches past the map
    bn = np.array([3, 2])
    _run(lambda a, b: jops.roi_align(a, b, bn, (3, 2), 0.5, aligned=aligned),
         lambda a, b: tops.roi_align(a, b, torch.from_numpy(bn), (3, 2), 0.5,
                                     aligned=aligned), [x, boxes])


def _clamp_clip(a, lo, hi):
    return a.clamp(lo, hi)


def test_roi_align_integer_boxes_halve_the_box_gradient(monkeypatch):
    """Integer boxes put every sample (bin centres at aligned=False) on an
    integer: y - floor(y) = 0 sits on clip's lower bound and the boxes'
    gradient through it is halved.  A clamp there passes it whole, which
    the same comparison must catch."""
    x = _x(1, 2, 10, 10, seed=12)
    boxes = np.array([[1, 1, 5, 7], [2, 0, 8, 4]], np.float32)

    def both():
        return _run(lambda a, b: jops.roi_align(a, b, None, 2, aligned=False),
                    lambda a, b: tops.roi_align(a, b, None, 2,
                                                aligned=False), [x, boxes])
    both()
    monkeypatch.setattr(tops, "_clip", _clamp_clip)
    with pytest.raises(AssertionError, match="gradient of input 1"):
        both()


# -- roi_pool ------------------------------------------------------------

def _relu_map():
    """A saturating ReLU's map (ReLU6 scaled to 1): half zeros, a quarter
    ones, so bins hold ties in irregular patterns (a bin of zeros alone is
    a rectangle, where both splits agree)."""
    return np.clip(_x(2, 3, 9, 11, seed=13, scale=1.5), 0.0, 1.0)


def test_roi_pool_matches_reference():
    boxes = _boxes(6, 18, 14)
    boxes[5] = [30.0, 30.0, 40.0, 40.0]            # off the map: zeros
    bn = np.array([2, 4])
    out, _, _ = _run(
        lambda a, b: jops.roi_pool(a, b, bn, (3, 4), 0.5),
        lambda a, b: tops.roi_pool(a, b, torch.from_numpy(bn), (3, 4), 0.5),
        [_relu_map(), boxes])
    assert not out[0][5].detach().any()


def test_roi_pool_takes_no_rois():
    """No RoIs at all: (0, C, oh, ow), as the reference's map over none
    (no extent to read back)."""
    x = _x(1, 3, 8, 8, seed=33)
    boxes = np.zeros((0, 4), np.float32)
    want = jops.roi_pool(paddle.to_tensor(x), paddle.to_tensor(boxes),
                         None, 2)
    got = tops.roi_pool(torch.from_numpy(x), torch.from_numpy(boxes), None, 2)
    assert tuple(got.shape) == tuple(want.shape) == (0, 3, 2, 2)


def _joint_amax_grad(x, boxes, oh, ow, scale):
    """roi_pool's input gradient of sum(out) if each bin took one joint
    amax over its window: 1 / (all ties) a tied cell."""
    xt = torch.from_numpy(x).requires_grad_()
    H, W = x.shape[2:]
    rows = tops._pool_bins(torch.from_numpy(boxes)[:, 1::2], scale, oh, H)
    cols = tops._pool_bins(torch.from_numpy(boxes)[:, 0::2], scale, ow, W)
    yy, xx = torch.arange(H), torch.arange(W)
    rm = (yy >= rows[0][..., None]) & (yy < (rows[0] + rows[1])[..., None])
    cm = (xx >= cols[0][..., None]) & (xx < (cols[0] + cols[1])[..., None])
    m = rm[:, :, None, :, None] & cm[:, None, :, None, :]   # (R,oh,ow,H,W)
    win = torch.where(m[:, None], xt[0][None, :, None, None], -torch.inf)
    out = win.amax((-2, -1))
    torch.where(torch.isfinite(out), out, 0.0).sum().backward()
    return xt.grad.numpy()


def test_roi_pool_ties_split_rows_then_columns():
    """On a saturating ReLU's map the gradient of a bin's max splits among
    equal cells as two reduce-maxes split it; the joint split differs, and
    the comparison must see it."""
    x = _relu_map()[:1]
    boxes = np.array([[0, 0, 10, 8], [2, 1, 9, 7]], np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jops.roi_pool(jx, paddle.to_tensor(boxes), None, 2).sum().backward()
    want = np.asarray(jx.grad._data)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    tops.roi_pool(tx, torch.from_numpy(boxes), None, 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, **TOL_GRAD)
    joint = _joint_amax_grad(x, boxes, 2, 2, 1.0)
    assert np.abs(joint - want).max() > 1e-2


def test_roi_pool_chunks_bitwise(monkeypatch):
    """RoIs in chunks of one give the same output and gradient."""
    x, boxes = _relu_map(), _boxes(5, 18, 15)

    def run():
        xt = torch.from_numpy(x.copy()).requires_grad_()
        out = tops.roi_pool(xt, torch.from_numpy(boxes),
                            torch.tensor([3, 2]), 3, 0.5)
        out.backward(torch.from_numpy(_x(*out.shape, seed=16)))
        return out.detach(), xt.grad
    whole = run()
    monkeypatch.setattr(tops, "_POOL_BUDGET", 1)
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


# -- deform_conv2d and DeformConv2D -------------------------------------

DCN_V2 = dict(stride=2, padding=1, dilation=2, groups=2, deformable_groups=2)


def _dcn_arrays(kw, mask):
    """x (2, 4, 9, 8), offsets, weight (6, 4 / groups, 3, 3), bias and,
    with ``mask``, a mask in [0, 1); offsets up to 3 pixels, so that
    corners fall outside the map."""
    N, Cin, H, W, Cout, k = 2, 4, 9, 8, 6, 3
    dg = kw.get("deformable_groups", 1)
    s, p, d = kw["stride"], kw["padding"], kw.get("dilation", 1)
    Ho = (H + 2 * p - (d * (k - 1) + 1)) // s + 1
    Wo = (W + 2 * p - (d * (k - 1) + 1)) // s + 1
    arrays = [_x(N, Cin, H, W, seed=17),
              _x(N, 2 * dg * k * k, Ho, Wo, seed=18, scale=1.5),
              _x(Cout, Cin // kw.get("groups", 1), k, k, seed=19),
              _x(Cout, seed=20)]
    if mask:
        arrays.append(np.random.default_rng(21).uniform(
            0, 1, (N, dg * k * k, Ho, Wo)).astype(np.float32))
    return arrays


@pytest.mark.parametrize("kw,mask", [(DCN_V2, True),
                                     (dict(stride=1, padding=1), False)])
def test_deform_conv2d_matches_reference(kw, mask):
    def call(ops):
        return lambda x, o, w, b, *m: ops.deform_conv2d(
            x, o, w, b, mask=m[0] if m else None, **kw)
    _run(call(jops), call(tops), _dcn_arrays(kw, mask))


def test_deform_conv2d_offset_layout_is_dy_dx():
    """A whole-pixel dx offset at every tap equals shifting the input left
    by it (away from the first output column, whose left taps read the
    padding of the shifted input but x itself when moved); the same value
    given as dy does not."""
    x = torch.from_numpy(_x(1, 2, 6, 7, seed=22))
    w = torch.from_numpy(_x(3, 2, 3, 3, seed=23))
    off = torch.zeros(1, 18, 6, 7)
    off[:, 1::2] = 1.0                             # dx = 1 at every tap
    shifted = torch.nn.functional.pad(x[..., 1:], (0, 1))
    want = tops.deform_conv2d(shifted, torch.zeros_like(off), w, padding=1)
    got = tops.deform_conv2d(x, off, w, padding=1)
    torch.testing.assert_close(got[..., 1:], want[..., 1:])
    swapped = tops.deform_conv2d(x, off.roll(1, 1), w, padding=1)
    assert not torch.allclose(swapped[..., 1:], want[..., 1:])


def test_deform_conv_layer_weights_by_name():
    """DeformConv2D's parameters carry from the reference's layer by name
    (``weight`` (out, in / groups, kh, kw), ``bias``); forward and every
    gradient on phase-31-like v2 inputs."""
    from paddle_tpu.vision.ops import DeformConv2D as JDeform
    kw = {k: v for k, v in DCN_V2.items()}
    paddle.seed(0)
    jm = JDeform(4, 6, 3, **kw)
    tm = tops.DeformConv2D(4, 6, 3, device="cpu", **kw)
    params = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    assert sorted(params) == ["bias", "weight"]
    assert params["weight"].shape == (6, 2, 3, 3)
    load_named_params(tm, params)
    x, off, _, _, m = _dcn_arrays(DCN_V2, True)
    want = jm(paddle.to_tensor(x), paddle.to_tensor(off),
              paddle.to_tensor(m))
    want.sum().backward()
    got = tm(torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(m))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               **TOL)
    ref = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(
            ref[n].grad._data), **TOL_GRAD, err_msg=n)


# -- yolo_loss, sigmoid_focal_loss, polygon_box_transform ---------------

def _gt(n, b, real, size, classes, seed):
    """(gt_box (n, b, 4) xywh in pixels, gt_label (n, b)): the first
    ``real`` rows boxes, the rest padding (w = 0 or label -1)."""
    r = np.random.default_rng(seed)
    box = np.zeros((n, b, 4), np.float32)
    box[:, :real, :2] = r.uniform(2, size - 2, (n, real, 2))
    box[:, :real, 2:] = r.uniform(4, size * 0.8, (n, real, 2))
    label = r.integers(0, classes, (n, b)).astype(np.int32)
    label[:, real + 1:] = -1                       # a padding row with w > 0
    box[:, real + 1:, 2:] = r.uniform(4, 9, (n, b - real - 1, 2))
    return box, label


@pytest.mark.parametrize("smooth,scale_x_y,score", [
    (True, 1.0, False), (False, 1.05, True), (True, 1.05, True)])
def test_yolo_loss_matches_reference(smooth, scale_x_y, score):
    classes, H = 4, 4
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    mask = [3, 4, 5]
    x = _x(2, 3 * (5 + classes), H, H, seed=27)
    box, label = _gt(2, 6, 4, 16 * H, classes, seed=28)
    arrays = [x, box, label]
    if score:
        arrays.append(np.random.default_rng(29).uniform(
            0.3, 1, (2, 6)).astype(np.float32))

    def call(ops):
        return lambda a, b, lab, *s: ops.yolo_loss(
            a, b, lab, anchors, mask, classes, 0.5, 16,
            gt_score=s[0] if s else None, use_label_smooth=smooth,
            scale_x_y=scale_x_y)
    out, _, _ = _run(call(jops), call(tops), arrays)
    assert tuple(out[0].shape) == (2,)


@pytest.mark.parametrize("reduction,norm", [("sum", True), ("mean", False),
                                            ("none", False)])
def test_sigmoid_focal_loss_matches_reference(reduction, norm):
    logit = _x(4, 5, seed=30, scale=2.0)
    label = (np.random.default_rng(31).uniform(size=(4, 5)) > 0.7).astype(
        np.float32)
    arrays = [logit, label] + ([np.array([3.0], np.float32)] if norm else [])

    def call(ops):
        return lambda lg, lb, *n: ops.sigmoid_focal_loss(
            lg, lb, n[0] if n else None, reduction=reduction)
    _, got, ref = _run(call(jops), call(tops), arrays)
    assert len(got) == len(arrays)          # label, normalizer: no gradient
    for g, r in zip(got[1:], ref[1:]):
        assert not g.any() and not r.any()


def test_polygon_box_transform_matches_reference():
    _run(jops.polygon_box_transform, tops.polygon_box_transform,
         [_x(2, 8, 3, 5, seed=32)])
