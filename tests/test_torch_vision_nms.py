"""The port's NMS family (``vision.ops``: ``nms``, ``_nms_keep`` with
``eta``, ``multiclass_nms``, ``matrix_nms``, ``locality_aware_nms``,
``retinanet_detection_output``) against the reference's host numpy on
the CPU, from the same numpy inputs.

Scores are distinct (a permutation of a grid), so that the ranking does
not depend on how a sort orders ties: the reference's ``np.argsort`` is
not stable, the port's sort is (``test_tied_scores_rank_in_input_order``
shows both orders).  Kept indices, counts and labels are held bitwise;
rows of boxes and scores copied from the inputs bitwise; matrix NMS's
decayed scores and the decodes within 1e-6 relative (f32).

The planted fault of ``chip_smoke.one_pass_keep`` (suppression by every
better box, kept or not: ``triu(iou > t).any(0)``) differs from greedy NMS
on a chain (A over B over C, A clear of C): the chain test shows it
dropping C."""
import numpy as np
import pytest
import torch

from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.vision import ops as tops
from chip_smoke import one_pass_keep

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else np.asarray(t)


def _boxes(n, hw, seed, lo=4.0, hi=20.0):
    """Boxes in clusters, so that many pairs overlap."""
    r = np.random.default_rng(seed)
    centre = r.uniform(0, hw, (max(1, n // 6), 2))[r.integers(
        0, max(1, n // 6), n)] + r.normal(0, 3, (n, 2))
    wh = r.uniform(lo, hi, (n, 2))
    return np.concatenate([centre - wh / 2, centre + wh / 2],
                          1).astype(np.float32)


def _scores(shape, seed, lo=0.0, hi=1.0):
    """Distinct f32 scores: a permutation of a grid over [lo, hi)."""
    n = int(np.prod(shape))
    grid = lo + (hi - lo) * np.arange(n) / n
    return np.random.default_rng(seed).permutation(grid).reshape(
        shape).astype(np.float32)


def _chain():
    """A over B over C: IoU(A, B) = IoU(B, C) = 1/3, A and C only touch."""
    return (np.array([[0, 0, 10, 10], [5, 0, 15, 10], [10, 0, 20, 10]],
                     np.float32), np.array([0.9, 0.8, 0.7], np.float32))


@pytest.mark.parametrize("thresh,top_k,with_scores", [
    (0.3, -1, True), (0.5, 5, True), (0.4, -1, False)])
def test_nms_matches_reference(thresh, top_k, with_scores):
    b = _boxes(60, 64, 0)
    s = _scores(60, 1)
    want = _np(jops.nms(b, s if with_scores else None, thresh, top_k))
    got = tops.nms(torch.from_numpy(b),
                   torch.from_numpy(s) if with_scores else None, thresh,
                   top_k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("thresh,eta,top_k", [(0.7, 0.9, -1),
                                              (0.6, 0.95, 7), (0.3, 1.0, 4)])
def test_nms_keep_adaptive_eta_matches_reference(thresh, eta, top_k):
    b = _boxes(80, 48, 2)
    s = _scores(80, 3)
    want = jops._nms_keep(b, s, thresh, top_k=top_k, eta=eta)
    got = tops._nms_keep(torch.from_numpy(b), torch.from_numpy(s), thresh,
                         top_k=top_k, eta=eta)
    np.testing.assert_array_equal(got.numpy(), want)


def test_threshold_compares_in_f32():
    """IoU 3 / 10 is f32(0.3), above 0.3 in f64: numpy 2 compares the f32
    IoU with the threshold rounded to f32, so the box survives (<=)."""
    b = np.array([[0, 0, 6.5, 1], [3.5, 0, 10, 1]], np.float32)
    s = np.array([0.9, 0.8], np.float32)
    want = jops._nms_keep(b, s, 0.3)
    got = tops._nms_keep(torch.from_numpy(b), torch.from_numpy(s), 0.3)
    np.testing.assert_array_equal(want, [0, 1])
    np.testing.assert_array_equal(got.numpy(), want)


def test_chain_greedy_keeps_c_where_one_pass_drops_it(monkeypatch):
    b, s = _chain()
    want = jops._nms_keep(b, s, 0.3)
    np.testing.assert_array_equal(want, [0, 2])
    got = tops.nms(torch.from_numpy(b), torch.from_numpy(s), 0.3)
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(tops, "_greedy_keep", one_pass_keep)
    faulty = tops.nms(torch.from_numpy(b), torch.from_numpy(s), 0.3)
    np.testing.assert_array_equal(faulty.numpy(), [0])


def test_tied_scores_rank_in_input_order():
    """40 scores of 0.5, then 10 of 0.7, disjoint boxes: the reference
    ranks the ties in numpy's introsort order, the port in input order.
    Both keep every box; the sets of each score agree."""
    n = 50
    b = np.stack([np.arange(n) * 3.0, np.zeros(n), np.arange(n) * 3.0 + 2,
                  np.ones(n) * 2], 1).astype(np.float32)
    s = np.array([0.5] * 40 + [0.7] * 10, np.float32)
    want = jops._nms_keep(b, s, 0.3)
    got = tops._nms_keep(torch.from_numpy(b), torch.from_numpy(s),
                         0.3).numpy()
    stable = np.concatenate([np.arange(40, 50), np.arange(40)])
    np.testing.assert_array_equal(got, stable)
    assert set(want[:10]) == set(range(40, 50)) and set(want[10:]) == set(
        range(40))
    print("reference order", want[:10], "port order", got[:10])
    assert not np.array_equal(want, stable), "numpy's argsort became stable"


def _multiclass_inputs(seed=4, N=2, M=40, C=4):
    b = np.stack([_boxes(M, 64, seed + n) for n in range(N)])
    s = _scores((N, C, M), seed + 10)
    s[1] *= 0.04             # image 1: no score above the threshold
    return b, s


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.05, nms_top_k=10, keep_top_k=15,
         nms_threshold=0.3, background_label=0),
    dict(score_threshold=0.2, nms_top_k=-1, keep_top_k=-1,
         nms_threshold=0.5, background_label=-1),
    dict(score_threshold=0.05, nms_top_k=12, keep_top_k=8,
         nms_threshold=0.7, nms_eta=0.8, background_label=2)])
def test_multiclass_nms_matches_reference(kw):
    b, s = _multiclass_inputs()
    jo, jn, ji = jops.multiclass_nms(b, s, return_index=True, **kw)
    to, tn, ti = tops.multiclass_nms(torch.from_numpy(b), torch.from_numpy(s),
                                     return_index=True, **kw)
    assert to.dtype == torch.float32 and tn.dtype == torch.int32
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(tn.numpy(), _np(jn))
    assert tn.numpy()[1] == 0
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(to.numpy(), _np(jo))
    t2 = tops.multiclass_nms(torch.from_numpy(b), torch.from_numpy(s), **kw)
    assert len(t2) == 2


def test_multiclass_nms_empty_batch():
    b, s = _multiclass_inputs()
    out, num = tops.multiclass_nms(torch.from_numpy(b),
                                   torch.from_numpy(s * 0.01))
    assert tuple(out.shape) == (0, 6) and num.tolist() == [0, 0]


@pytest.mark.parametrize("gaussian,post", [(False, 0.0), (True, 0.0),
                                           (False, 0.1), (True, 0.15)])
def test_matrix_nms_matches_reference(gaussian, post):
    b, s = _multiclass_inputs(seed=7)
    kw = dict(score_threshold=0.05, post_threshold=post, nms_top_k=15,
              keep_top_k=20, use_gaussian=gaussian, gaussian_sigma=2.0,
              background_label=0)
    jo, jn, ji = jops.matrix_nms(b, s, **kw)
    to, tn, ti = tops.matrix_nms(torch.from_numpy(b), torch.from_numpy(s),
                                 **kw)
    np.testing.assert_array_equal(tn.numpy(), _np(jn))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)


def test_locality_aware_nms_matches_reference():
    """An EAST-like map: rows of boxes, consecutive ones overlapping
    (merged) and a row break between text lines."""
    r = np.random.default_rng(5)
    rows = []
    for line in range(4):
        x = np.arange(12) * 2.0
        y = np.full(12, line * 12.0)
        rows.append(np.stack([x, y, x + 8, y + 6], 1) + r.normal(0, .3,
                                                                (12, 4)))
    b = np.concatenate(rows).astype(np.float32)
    s = r.uniform(0, 1, len(b)).astype(np.float32)
    for kw in (dict(), dict(nms_top_k=3, keep_top_k=2, nms_threshold=0.2)):
        want = _np(jops.locality_aware_nms(b, s, **kw))
        got = tops.locality_aware_nms(torch.from_numpy(b),
                                      torch.from_numpy(s), **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert got.shape[1] == 5
    assert tops.locality_aware_nms(torch.from_numpy(b), torch.from_numpy(
        s * 0)).shape == (0, 5)


def test_retinanet_detection_output_matches_reference():
    r = np.random.default_rng(6)
    bbs, scs, ans = [], [], []
    for lvl, (n, size) in enumerate(((60, 16.0), (20, 32.0))):
        an = _boxes(n, 64, 20 + lvl, lo=size, hi=size * 1.5)
        ans.append(an)
        bbs.append((r.normal(0, 0.3, (n, 4))).astype(np.float32))
        scs.append(_scores((n, 3), 30 + lvl))
    im_info = np.array([[60.0, 70.0, 1.0]], np.float32)
    for kw in (dict(score_threshold=0.3, nms_top_k=25, keep_top_k=30,
                    nms_threshold=0.45),
               dict(score_threshold=0.5, nms_top_k=-1, keep_top_k=10,
                    nms_threshold=0.6, nms_eta=0.9)):
        want = _np(jops.retinanet_detection_output(bbs, scs, ans, im_info,
                                                   **kw))
        got = tops.retinanet_detection_output(
            [torch.from_numpy(a) for a in bbs],
            [torch.from_numpy(a) for a in scs],
            [torch.from_numpy(a) for a in ans], torch.from_numpy(im_info),
            **kw)
        assert got.shape == want.shape and len(want)
        np.testing.assert_array_equal(got.numpy()[:, 0], want[:, 0])
        np.testing.assert_allclose(got.numpy(), want, **TOL)
