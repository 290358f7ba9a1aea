"""The port's losses (every functional of ``nn/functional/loss.py`` beside
cross-entropy and NLL, and their layers, ``HSigmoidLoss`` and ``NCELoss``
included) against the reference on the CPU, from the same numpy inputs:
the loss under each reduction and the gradients of sum(out * w) for a
fixed random w with respect to every floating input.

CTC holds the reference's contract and its two quirks: an empty label
scores -log(2 p), ln 2 below PyTorch's ``F.ctc_loss``, and an alignment
no path reaches keeps a finite loss near 1e30 where ``F.ctc_loss`` gives
inf.  The heads draw their weights (and ``NCELoss`` its negatives) from
the same numpy generator in both packages.  Tolerance: f32 values and
gradients 1e-5 absolute and relative; CTC's losses sum 30 log-domain
steps, held at 1e-4 relative."""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as PF

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_CTC = dict(rtol=1e-4, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _run(jfn, tfn, arrays, seed=13, tol=TOL):
    """Both on the numpy ``arrays``: the output and the gradient of every
    f32 input.  Returns the port's output."""
    js = [paddle.to_tensor(a, stop_gradient=a.dtype != np.float32)
          for a in arrays]
    ts = [torch.from_numpy(a.copy()).requires_grad_(a.dtype == np.float32)
          for a in arrays]
    oj, ot = jfn(*js), tfn(*ts)
    want = np.asarray(oj._data)
    np.testing.assert_allclose(ot.detach().numpy(), want, **tol,
                               err_msg="output")
    w = _rng(seed).standard_normal(want.shape).astype(np.float32)
    (oj * paddle.to_tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    for i, (j, t) in enumerate(zip(js, ts)):
        if t.requires_grad:     # no path to an input: a zero gradient
            got = t.grad if t.grad is not None else torch.zeros_like(t)
            np.testing.assert_allclose(got.numpy(), np.asarray(j.grad._data),
                                       **tol,
                                       err_msg=f"gradient of input {i}")
    return ot


def _n(*shape, seed=0):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _u(*shape, seed=0, lo=0.0, hi=1.0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _sign(*shape, seed=0):
    return np.where(_rng(seed).random(shape) < 0.5, -1.0, 1.0).astype(
        np.float32)


def _both(name, *args, **kw):
    return (lambda *t: getattr(JF, name)(*t, *args, **kw),
            lambda *t: getattr(TF, name)(*t, *args, **kw))


N, C = 6, 5
# (functional, inputs, kwargs); each runs under every reduction it takes
LOSSES = [
    ("binary_cross_entropy", lambda: [_u(N, C, lo=0.02, hi=0.98),
                                      _u(N, C, seed=1)], {}),
    ("binary_cross_entropy", lambda: [_u(N, C, lo=0.02, hi=0.98),
                                      _u(N, C, seed=1), _u(N, C, seed=2)],
     {}),
    ("binary_cross_entropy_with_logits",
     lambda: [_n(N, C) * 3, _u(N, C, seed=1)], {}),
    ("binary_cross_entropy_with_logits",
     lambda: [_n(N, C) * 3, _u(N, C, seed=1), _u(N, C, seed=2),
              _u(C, seed=3, hi=3)], {}),
    ("l1_loss", lambda: [_n(N, C), _n(N, C, seed=1)], {}),
    ("mse_loss", lambda: [_n(N, C), _n(N, C, seed=1)], {}),
    ("smooth_l1_loss", lambda: [_n(N, C), _n(N, C, seed=1)],
     dict(delta=0.7)),
    ("kl_div", lambda: [np.log(_u(N, C, lo=0.05)), _u(N, C, seed=1)], {}),
    ("margin_ranking_loss", lambda: [_n(N), _n(N, seed=1), _sign(N, seed=2)],
     dict(margin=0.3)),
    ("hinge_embedding_loss", lambda: [_n(N, C), _sign(N, C, seed=1)],
     dict(margin=0.8)),
    ("cosine_embedding_loss",
     lambda: [_n(N, C), _n(N, C, seed=1), _sign(N, seed=2)],
     dict(margin=0.2)),
    ("triplet_margin_loss",
     lambda: [_n(N, C), _n(N, C, seed=1), _n(N, C, seed=2)], {}),
    ("triplet_margin_loss",
     lambda: [_n(N, C), _n(N, C, seed=1), _n(N, C, seed=2)],
     dict(p=1.0, swap=True, margin=2.0)),
    ("soft_margin_loss", lambda: [_n(N, C), _sign(N, C, seed=1)], {}),
    ("sigmoid_focal_loss",
     lambda: [_n(N, C) * 2, (_u(N, C, seed=1) < 0.3).astype(np.float32)],
     {}),
    ("sigmoid_focal_loss",
     lambda: [_n(N, C) * 2, (_u(N, C, seed=1) < 0.3).astype(np.float32),
              np.array([3.0], np.float32)], dict(alpha=0.5, gamma=1.5)),
]


def _with_reduction(name, kw, reduction):
    if name == "sigmoid_focal_loss":
        def call(mod):
            return lambda z, lab, *nz: getattr(mod, name)(
                z, lab, nz[0] if nz else None, reduction=reduction, **kw)
        return call(JF), call(TF)
    if name in ("binary_cross_entropy", "binary_cross_entropy_with_logits"):
        def call(mod):
            def fn(a, lab, *rest):
                extra = dict(zip(("weight", "pos_weight"), rest))
                return getattr(mod, name)(a, lab, reduction=reduction,
                                          **extra, **kw)
            return fn
        return call(JF), call(TF)
    return _both(name, reduction=reduction, **kw)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", LOSSES, ids=lambda c: c[0])
def test_loss_matches_reference(case, reduction):
    name, make, kw = case
    _run(*_with_reduction(name, kw, reduction), make())


def test_kl_div_batchmean_matches_reference():
    _run(*_both("kl_div", reduction="batchmean"),
         [np.log(_u(N, C, lo=0.05)), _u(N, C, seed=1)])


@pytest.mark.parametrize("name,make", [
    ("square_error_cost", lambda: [_n(N, C), _n(N, C, seed=1)]),
    ("log_loss", lambda: [_u(N, 1, lo=0.05, hi=0.95), _u(N, 1, seed=1)]),
    ("dice_loss", lambda: [_u(N, 4, C), _rng(2).integers(
        0, C, (N, 4, 1)).astype(np.int64)]),
    ("npair_loss", lambda: [_n(N, C), _n(N, C, seed=1),
                            _rng(2).integers(0, 3, N).astype(np.int64)]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_unreduced_losses_match_reference(name, make):
    _run(*_both(name), make())


def test_jnp_tie_rules_in_the_gradients():
    """max(0, x) at x = 0 passes half the gradient (JAX's max), as the
    port's margin losses do; the clip of the BCE input at 1 - 1e-12 (1.0
    in f32) passes half at p = 1."""
    _run(*_both("margin_ranking_loss", reduction="sum"),
         [np.array([1.0, 2.0], np.float32), np.array([1.0, 0.5], np.float32),
          np.array([1.0, 1.0], np.float32)])
    _run(*_both("binary_cross_entropy", reduction="sum"),
         [np.array([1.0, 0.5], np.float32), np.array([1.0, 0.0], np.float32)])


# -- CTC ---------------------------------------------------------------------

def _ctc_case(t, n, c, s, seed, blank=0):
    r = _rng(seed)
    logits = r.standard_normal((t, n, c)).astype(np.float32)
    lab_len = r.integers(1, s + 1, n).astype(np.int64)
    labels = np.zeros((n, s), np.int64)
    for i, ln in enumerate(lab_len):
        labels[i, :ln] = [(v + blank + 1) % c for v in r.integers(0, c - 1,
                                                                  ln)]
    in_len = r.integers(2 * s + 1, t + 1, n).astype(np.int64)
    return [logits, labels, in_len, lab_len]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("blank", [0, 3])
def test_ctc_loss_matches_reference(reduction, blank):
    _run(*_both("ctc_loss", blank=blank, reduction=reduction),
         _ctc_case(30, 4, 6, 5, seed=blank, blank=blank), tol=TOL_CTC)


def test_ctc_loss_with_repeats_matches_torch_and_reference():
    """A feasible batch with repeated labels: the reference, the port and
    PyTorch's F.ctc_loss agree on every per-sample loss."""
    logits, labels, in_len, lab_len = _ctc_case(30, 4, 6, 5, seed=9)
    labels[0, :3] = [2, 2, 2]
    lab_len[0] = max(lab_len[0], 3)
    out = _run(*_both("ctc_loss", reduction="none"),
               [logits, labels, in_len, lab_len], tol=TOL_CTC)
    want = PF.ctc_loss(torch.log_softmax(torch.from_numpy(logits), -1),
                       torch.from_numpy(labels), torch.from_numpy(in_len),
                       torch.from_numpy(lab_len), reduction="none")
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                               **TOL_CTC)


def test_ctc_empty_label_scores_minus_log_two_p():
    """An empty label: the reference's loss is -log(2 p), p the all-blank
    path's probability (its two final terms are the same alpha), ln 2
    below F.ctc_loss's -log p; the port reproduces it."""
    logits, labels, in_len, lab_len = _ctc_case(20, 3, 5, 4, seed=4)
    lab_len[1] = 0
    labels[1] = 0
    out = _run(*_both("ctc_loss", reduction="none"),
               [logits, labels, in_len, lab_len], tol=TOL_CTC)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    want = PF.ctc_loss(lp, torch.from_numpy(labels), torch.from_numpy(in_len),
                       torch.from_numpy(lab_len), reduction="none")
    p_blank = -float(lp[:in_len[1], 1, 0].sum())
    np.testing.assert_allclose(float(want[1]), p_blank, rtol=1e-5)
    np.testing.assert_allclose(float(out.detach()[1]), p_blank - math.log(2),
                               rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy()[[0, 2]],
                               want.numpy()[[0, 2]], **TOL_CTC)


def test_ctc_unreachable_alignment_is_finite():
    """A label longer than its input can emit: F.ctc_loss gives inf, the
    reference and the port a finite loss near 1e30 (NEG = -1e30)."""
    logits, labels, in_len, lab_len = _ctc_case(20, 3, 5, 4, seed=5)
    labels[2] = [1, 2, 3, 4]
    lab_len[2], in_len[2] = 4, 3
    out = _run(*_both("ctc_loss", reduction="none"),
               [logits, labels, in_len, lab_len], tol=TOL_CTC)
    want = PF.ctc_loss(torch.log_softmax(torch.from_numpy(logits), -1),
                       torch.from_numpy(labels), torch.from_numpy(in_len),
                       torch.from_numpy(lab_len), reduction="none")
    assert math.isinf(float(want[2]))
    assert math.isfinite(float(out.detach()[2]))
    assert float(out.detach()[2]) > 1e29


# -- layers ------------------------------------------------------------------

LAYERS = [
    ("MSELoss", (), dict(reduction="sum"),
     lambda: [_n(N, C), _n(N, C, seed=1)]),
    ("L1Loss", (), {}, lambda: [_n(N, C), _n(N, C, seed=1)]),
    ("BCELoss", (), {},
     lambda: [_u(N, C, lo=0.02, hi=0.98), _u(N, C, seed=1)]),
    ("BCEWithLogitsLoss", (), {}, lambda: [_n(N, C), _u(N, C, seed=1)]),
    ("SmoothL1Loss", (), dict(delta=0.5),
     lambda: [_n(N, C), _n(N, C, seed=1)]),
    ("KLDivLoss", (), dict(reduction="batchmean"),
     lambda: [np.log(_u(N, C, lo=0.05)), _u(N, C, seed=1)]),
    ("MarginRankingLoss", (), dict(margin=0.1),
     lambda: [_n(N), _n(N, seed=1), _sign(N, seed=2)]),
    ("HingeEmbeddingLoss", (), {}, lambda: [_n(N, C), _sign(N, C, seed=1)]),
    ("CosineEmbeddingLoss", (), {},
     lambda: [_n(N, C), _n(N, C, seed=1), _sign(N, seed=2)]),
    ("SigmoidFocalLoss", (), dict(reduction="mean"),
     lambda: [_n(N, C), (_u(N, C, seed=1) < 0.3).astype(np.float32)]),
    ("TripletMarginLoss", (), dict(swap=True),
     lambda: [_n(N, C), _n(N, C, seed=1), _n(N, C, seed=2)]),
    ("SoftMarginLoss", (), {}, lambda: [_n(N, C), _sign(N, C, seed=1)]),
    ("CTCLoss", (), dict(blank=2), lambda: _ctc_case(16, 3, 5, 4, 1, 2)),
]


@pytest.mark.parametrize("case", LAYERS, ids=lambda c: c[0])
def test_loss_layers_match_reference(case):
    name, args, kw, make = case
    _run(getattr(jnn, name)(*args, **kw), getattr(tnn, name)(*args, **kw),
         make(), tol=TOL_CTC if name == "CTCLoss" else TOL)


def _head_run(jl, tl, arrays, calls):
    """The heads' weights equal at construction; ``calls`` forwards with
    the same inputs (NCELoss draws new negatives each call), outputs and
    the gradients of the input and every parameter after each."""
    for (k, jp), (k2, tp) in zip(jl.named_parameters(),
                                 tl.named_parameters()):
        assert k == k2
        np.testing.assert_array_equal(tp.detach().numpy(),
                                      np.asarray(jp._data))
    for _ in range(calls):
        jx = paddle.to_tensor(arrays[0], stop_gradient=False)
        tx = torch.from_numpy(arrays[0].copy()).requires_grad_()
        oj = jl(jx, paddle.to_tensor(arrays[1]))
        ot = tl(tx, torch.from_numpy(arrays[1]))
        np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj._data),
                                   **TOL)
        oj.sum().backward()
        ot.sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                                   **TOL)
        for (k, jp), (_, tp) in zip(jl.named_parameters(),
                                    tl.named_parameters()):
            np.testing.assert_allclose(tp.grad.numpy(),
                                       np.asarray(jp.grad._data), **TOL,
                                       err_msg=k)
            jp.clear_grad()
            tp.grad = None


def test_hsigmoid_loss_layer_matches_reference():
    jl = jnn.HSigmoidLoss(8, 11)
    tl = tnn.HSigmoidLoss(8, 11, device="cpu")
    _head_run(jl, tl, [_n(N, 8), _rng(3).integers(0, 11, N).astype(
        np.int64)], calls=1)


def test_nce_loss_samples_the_reference_negatives():
    jl = jnn.NCELoss(50, 8, num_neg_samples=5, seed=7)
    tl = tnn.NCELoss(50, 8, num_neg_samples=5, seed=7, device="cpu")
    _head_run(jl, tl, [_n(N, 8), _rng(3).integers(0, 50, (N, 1)).astype(
        np.int64)], calls=3)


def test_nce_loss_refuses_other_samplers():
    with pytest.raises(NotImplementedError, match="uniform"):
        tnn.NCELoss(50, 8, sampler="log_uniform", device="cpu")
