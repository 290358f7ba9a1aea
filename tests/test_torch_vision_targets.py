"""The port's detection target and proposal stages (``vision.ops``:
``bipartite_match``, ``target_assign``, ``mine_hard_examples``,
``box_decoder_and_assign``, ``generate_proposals``,
``distribute_fpn_proposals``, ``collect_fpn_proposals``,
``rpn_target_assign``, ``retinanet_target_assign``,
``generate_proposal_labels``, ``generate_mask_labels``,
``roi_perspective_transform``) against the reference on the CPU from the
same numpy inputs.

Indices, labels, matches and sampled RoIs are held bitwise, the sampling
stages with ``use_random=True`` too: the port draws from the reference's
``np.random.default_rng(seed)`` with the same calls in the same order.
Values are held within 1e-6 relative (f32: the encodes' ``log`` and the
decodes' ``exp`` may round differently), the gradients of
``box_decoder_and_assign`` and ``roi_perspective_transform`` within 1e-5.
Scores are distinct, so no ranking depends on how a sort orders ties."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.vision import ops as tops

TOL = dict(rtol=1e-6, atol=1e-6)
TOL_GRAD = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else np.asarray(t)


def _boxes(n, hw, seed, lo=4.0, hi=24.0):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, hw - lo, (n, 2))
    wh = r.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want, exact=True):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# -- SSD stages ------------------------------------------------------------

@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_matches_reference(match_type):
    r = np.random.default_rng(0)
    d = r.permutation(np.linspace(-0.3, 0.95, 6 * 14)).reshape(6, 14)
    d = d.astype(np.float32)
    d[4:] = -0.1                  # rows 4, 5 never match: the loop stops
    ji, jd = jops.bipartite_match(d, match_type, 0.4)
    ti, td = tops.bipartite_match(_t(d), match_type, 0.4)
    _same(ti, ji)
    _same(td, jd)
    assert (ti >= 0).sum() > 4 if match_type == "per_prediction" else True


def test_target_assign_and_mining_match_reference():
    r = np.random.default_rng(1)
    N, M, P = 3, 5, 30
    mi = r.integers(-1, M, (N, P)).astype(np.int64)
    mi[:, ::3] = -1
    loss = r.permutation(np.arange(N * P)).reshape(N, P).astype(np.float32)
    for kw in (dict(neg_pos_ratio=0.5),
               dict(mining_type="hard_example", sample_size=4),
               dict(mining_type="hard_example")):
        jneg, jmi = jops.mine_hard_examples(loss, mi, **kw)
        tneg, tmi = tops.mine_hard_examples(_t(loss), _t(mi), **kw)
        _same(tmi, jmi)
        assert len(tneg) == N
        for a, b in zip(tneg, jneg):
            _same(a, b)
    with pytest.raises(ValueError):
        tops.mine_hard_examples(_t(loss), _t(mi), mining_type="other")
    loc = r.standard_normal((N, M, 4)).astype(np.float32)
    lab = r.integers(1, 21, (N, M, 1)).astype(np.int32)
    for inp, mis in ((loc, 0.0), (lab, 0)):
        jo, jw = jops.target_assign(inp, mi, jneg, mis)
        to, tw = tops.target_assign(_t(inp), _t(mi), tneg, mis)
        _same(to, jo)
        _same(tw, jw)
    jo, jw = jops.target_assign(loc, mi)
    to, tw = tops.target_assign(_t(loc), _t(mi))
    _same(to, jo)
    _same(tw, jw)


# -- decode -----------------------------------------------------------------

def test_box_decoder_and_assign_values_and_gradients():
    r = np.random.default_rng(2)
    N, C = 12, 5
    pb = _boxes(N, 64, 3)
    pbv = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (N, 1))
    tb = r.normal(0, 1.0, (N, 4 * C)).astype(np.float32)
    tb[0, 2] = 41.35              # exp(min(d, clip)) at the clip, a tie
    sc = r.permutation(np.linspace(0, 1, N * C)).reshape(N, C).astype(
        np.float32)
    arrays = [pb, pbv, tb, sc]
    js = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    ts = [_t(a.copy()).requires_grad_() for a in arrays]
    jo = jops.box_decoder_and_assign(*js)
    to = tops.box_decoder_and_assign(*ts)
    w = [r.standard_normal(o.shape).astype(np.float32) for o in to]
    lj = lt = 0
    for j, t, wi in zip(jo, to, w):
        np.testing.assert_allclose(t.detach().numpy(), _np(j), **TOL)
        lj = lj + (j * paddle.to_tensor(wi)).sum()
        lt = lt + (t * _t(wi)).sum()
    lj.backward()
    lt.backward()
    for j, t in zip(js, ts):
        want = (_np(j.grad) if j.grad is not None
                else np.zeros(t.shape, np.float32))
        got = (t.grad.numpy() if t.grad is not None
               else np.zeros(t.shape, np.float32))
        np.testing.assert_allclose(got, want, **TOL_GRAD)


# -- proposals --------------------------------------------------------------

def _rpn_level(N=2, A=3, H=6, W=7, seed=4):
    r = np.random.default_rng(seed)
    feat = paddle.to_tensor(np.zeros((N, 8, H, W), np.float32))
    an, var = jops.anchor_generator(feat, [12.0], [0.5, 1.0, 2.0],
                                    stride=(8.0, 8.0))
    sc = r.permutation(np.linspace(0.01, 0.99, N * A * H * W)).reshape(
        N, A, H, W).astype(np.float32)
    bd = r.normal(0, 0.5, (N, 4 * A, H, W)).astype(np.float32)
    ims = np.array([[H * 8.0 - 5, W * 8.0 - 3]] * N, np.float32)
    return sc, bd, ims, _np(an), _np(var)


@pytest.mark.parametrize("kw", [
    dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.5, min_size=2.0),
    dict(pre_nms_top_n=-1, post_nms_top_n=1000, nms_thresh=0.7,
         min_size=0.0, eta=0.5)])
def test_generate_proposals_matches_reference(kw):
    """``eta`` is accepted and ignored, in both."""
    sc, bd, ims, an, var = _rpn_level()
    jr, js, jn = jops.generate_proposals(sc, bd, ims, an, var,
                                         return_rois_num=True, **kw)
    tr, ts_, tn = tops.generate_proposals(_t(sc), _t(bd), _t(ims), _t(an),
                                          _t(var), return_rois_num=True, **kw)
    _same(tn, jn)
    _same(tr, jr, exact=False)
    _same(ts_, js)
    kw1 = dict(kw, eta=1.0)
    t1 = tops.generate_proposals(_t(sc), _t(bd), _t(ims), _t(an), _t(var),
                                 **kw1)
    assert torch.equal(t1[0], tr)


def test_fpn_distribute_and_collect_match_reference():
    r = np.random.default_rng(5)
    n = 40
    xy = r.uniform(0, 400, (n, 2))
    side = np.exp(r.uniform(np.log(8), np.log(600), (n, 2)))
    rois = np.concatenate([xy, xy + side], 1).astype(np.float32)
    jm, jr, jn = jops.distribute_fpn_proposals(rois, 2, 5, 4, 224)
    tm, tr, tn = tops.distribute_fpn_proposals(_t(rois), 2, 5, 4, 224)
    _same(tr, jr)
    _same(tn, jn)
    assert len(tm) == len(jm) == 4
    for a, b in zip(tm, jm):
        _same(a, b)
    flat = r.permutation(np.linspace(0, 1, n)).astype(np.float32)
    scores = np.split(flat, np.cumsum([len(_np(m)) for m in jm])[:-1])
    for top in (7, 100):
        want = jops.collect_fpn_proposals(jm, scores, top)
        got = tops.collect_fpn_proposals(tm, [_t(s) for s in scores], top)
        _same(got, want)


# -- training targets -------------------------------------------------------

def _gts(seed, n_img=3, hw=96):
    r = np.random.default_rng(seed)
    gts, crowd, labels = [], [], []
    for i in range(n_img):
        g = 0 if i == 1 else 5           # image 1 has no gt
        gts.append(_boxes(g, hw, seed + i, lo=10, hi=40).reshape(-1, 4))
        c = np.zeros(g, bool)
        if g:
            c[0] = True                  # a crowd gt
        crowd.append(c)
        labels.append(r.integers(1, 9, g).astype(np.int64))
    return gts, crowd, labels


def _anchors(hw=96, stride=8.0):
    feat = paddle.to_tensor(np.zeros((1, 1, int(hw // stride),
                                      int(hw // stride)), np.float32))
    an, _ = jops.anchor_generator(feat, [16.0, 32.0], [0.5, 1.0, 2.0],
                                  stride=(stride, stride))
    return _np(an).reshape(-1, 4)


@pytest.mark.parametrize("use_random,straddle", [(True, 0.0), (False, 0.0),
                                                 (True, -1.0)])
def test_rpn_target_assign_matches_reference(use_random, straddle):
    an = _anchors()
    gts, crowd, _ = _gts(6)
    im_info = np.array([[90.0, 93.0, 1.0]] * len(gts), np.float32)
    kw = dict(rpn_batch_size_per_im=32, rpn_straddle_thresh=straddle,
              rpn_fg_fraction=0.25, use_random=use_random, seed=3)
    want = jops.rpn_target_assign(an, gts, crowd, im_info, **kw)
    got = tops.rpn_target_assign(_t(an), [_t(g) for g in gts],
                                 [_t(c) for c in crowd], _t(im_info), **kw)
    for k, (g, w) in enumerate(zip(got, want)):
        _same(g, w, exact=k != 2)
    assert got[2].dtype == torch.float32
    n_img_fg = [(got[0].numpy() // len(an) == i).sum() for i in range(3)]
    assert n_img_fg[1] == 0 and min(n_img_fg[0], n_img_fg[2]) > 0


def test_retinanet_target_assign_matches_reference():
    an = _anchors()
    gts, crowd, labels = _gts(7)
    want = jops.retinanet_target_assign(an, gts, labels, crowd, 0.5, 0.4)
    got = tops.retinanet_target_assign(_t(an), [_t(g) for g in gts],
                                       [_t(lb) for lb in labels],
                                       [_t(c) for c in crowd], 0.5, 0.4)
    for k, (g, w) in enumerate(zip(got, want)):
        _same(g, w, exact=k != 2)
    one = tops.retinanet_target_assign(_t(an), _t(gts[0]), _t(labels[0]))
    jone = jops.retinanet_target_assign(an, gts[0], labels[0])
    for g, w in zip(one, jone):
        _same(g, w, exact=False)


def _proposal_inputs(seed=8):
    gts, crowd, labels = _gts(seed, n_img=2)
    r = np.random.default_rng(seed)
    rois = []
    for i, g in enumerate(gts):
        near = (g[r.integers(0, len(g), 60)] + r.normal(0, 4, (60, 4))
                if len(g) else np.zeros((0, 4)))
        rois.append(np.concatenate([near, _boxes(40, 96, seed + 9 + i)]
                                   ).astype(np.float32))
    return rois, labels, crowd, gts


@pytest.mark.parametrize("use_random,agnostic", [(True, False),
                                                 (False, False),
                                                 (True, True)])
def test_generate_proposal_labels_matches_reference(use_random, agnostic):
    rois, labels, crowd, gts = _proposal_inputs()
    kw = dict(batch_size_per_im=24, fg_fraction=0.25, fg_thresh=0.5,
              bg_thresh_hi=0.5, bg_thresh_lo=0.0, class_nums=9,
              use_random=use_random, is_cls_agnostic=agnostic, seed=11)
    want = jops.generate_proposal_labels(rois, labels, crowd, gts, **kw)
    got = tops.generate_proposal_labels([_t(a) for a in rois],
                                        [_t(a) for a in labels],
                                        [_t(a) for a in crowd],
                                        [_t(a) for a in gts], **kw)
    for k, (g, w) in enumerate(zip(got, want)):
        _same(g, w, exact=k not in (2,))
    assert (got[1] > 0).sum() > 0


def _polygon(cx, cy, rad, k, seed):
    a = np.sort(np.random.default_rng(seed).uniform(0, 2 * np.pi, k))
    return np.stack([cx + rad * np.cos(a), cy + rad * np.sin(a)],
                    1).astype(np.float32)


def test_generate_mask_labels_matches_reference():
    r = np.random.default_rng(12)
    segms, classes, crowd, rois, labs = [], [], [], [], []
    for i in range(2):
        g = 4
        centres = r.uniform(20, 76, (g, 2))
        segms.append([[_polygon(cx, cy, 12, 6, 100 * i + j)]
                      + ([_polygon(cx + 5, cy, 4, 3, 7)] if j == 0 else [])
                      for j, (cx, cy) in enumerate(centres)])
        classes.append(np.array([1, 2, 2, 3], np.int64))
        crowd.append(np.array([False, False, False, i == 1]))
        ro = np.concatenate([centres - 10, centres + 10], 1)
        ro = np.concatenate([ro, _boxes(3, 96, 40 + i)]).astype(np.float32)
        rois.append(ro)
        labs.append(np.array([1, 2, 0, 3, 0, 2, 0], np.int32))
    for res in (8, 14):
        want = jops.generate_mask_labels(None, classes, crowd, segms, rois,
                                         labs, num_classes=5,
                                         resolution=res)
        got = tops.generate_mask_labels(None, classes, crowd, segms,
                                        [_t(a) for a in rois],
                                        [_t(a) for a in labs],
                                        num_classes=5, resolution=res)
        for g, w in zip(got, want):
            _same(g, w)
    empty = tops.generate_mask_labels(None, classes, crowd, segms,
                                      [_t(a) for a in rois],
                                      [_t(a * 0) for a in labs],
                                      num_classes=5, resolution=8)
    assert [tuple(t.shape) for t in empty] == [(0, 4), (0,), (0, 320)]


# -- perspective ------------------------------------------------------------

@pytest.mark.parametrize("n_img", [1, 2])
def test_roi_perspective_transform_values_and_gradients(n_img):
    r = np.random.default_rng(13)
    x = r.standard_normal((n_img, 3, 20, 24)).astype(np.float32)
    quads = []
    for _ in range(5):
        cx, cy = r.uniform(4, 20), r.uniform(4, 16)
        quad = np.array([[-6, -3], [6, -4], [7, 4], [-5, 3]], np.float64)
        quads.append((quad + [cx, cy] + r.normal(0, 0.5, (4, 2))).reshape(-1))
    quads[0] = quads[0] + 30            # partly outside the map: zeros
    rois = np.asarray(quads, np.float32) * 2.0
    bn = [3, 2] if n_img == 2 else None
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = _t(x.copy()).requires_grad_()
    jo = jops.roi_perspective_transform(jx, rois, 6, 9, 0.5, boxes_num=bn)
    to = tops.roi_perspective_transform(tx, _t(rois), 6, 9, 0.5,
                                        boxes_num=bn)
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)
    assert (to[0] == 0).any()
    w = r.standard_normal(to.shape).astype(np.float32)
    (jo * paddle.to_tensor(w)).sum().backward()
    (to * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), **TOL_GRAD)
    if n_img == 2:
        with pytest.raises(ValueError, match="boxes_num"):
            tops.roi_perspective_transform(tx, _t(rois), 6, 9)
