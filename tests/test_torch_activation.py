"""The port's activations (nn/functional/activation.py, nn/layer/activation
.py) against the reference on the CPU: every functional's value and its
gradient along a random cotangent, on the same numpy input (no entry at a
kink), every layer at its defaults, ``PReLU``'s weight gradient, and the
random ones (``rrelu`` in training, ``gumbel_softmax``) by their
distributions, drawn from an explicit generator.

Tolerance: values 1e-6 absolute plus 1e-5 relative (XLA's and PyTorch's
transcendentals differ by an ulp or two); gradients 1e-5 absolute plus
1e-5 relative (the exact GELU's derivative cancels near x = -0.75, where
the two differ by up to 1.7e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

TOL = dict(atol=1e-6, rtol=1e-5)
TOL_GRAD = dict(atol=1e-5, rtol=1e-5)
SHAPE = (2, 4, 3, 6)

CASES = [
    ("relu", {}), ("relu6", {}), ("elu", {"alpha": 0.5}), ("selu", {}),
    ("celu", {"alpha": 1.5}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("sigmoid", {}), ("hardsigmoid", {}), ("hardswish", {}),
    ("hardtanh", {"min": -0.5, "max": 0.8}), ("hardshrink", {}),
    ("softshrink", {"threshold": 0.3}), ("tanhshrink", {}),
    ("leaky_relu", {"negative_slope": 0.1}), ("log_sigmoid", {}),
    ("silu", {}), ("swish", {}), ("mish", {}),
    ("softplus", {"beta": 2.0, "threshold": 5.0}), ("softplus", {}),
    ("softsign", {}), ("tanh", {}), ("thresholded_relu", {"threshold": 0.4}),
    ("glu", {"axis": 1}), ("glu", {}), ("maxout", {"groups": 2}),
    ("softmax", {"axis": 1}), ("log_softmax", {}), ("rrelu", {}),
]


def _input(seed=0):
    x = 3.0 * np.random.default_rng(seed).standard_normal(SHAPE)
    # keep clear of the kinks at 0, +-0.3, +-0.5, 0.4, 0.8, 6, -3, 3, 1
    for k in (0.0, 0.3, -0.3, 0.5, -0.5, 0.4, 0.8, 6.0, -3.0, 3.0, 1.0):
        x = np.where(np.abs(x - k) < 1e-3, x + 0.01, x)
    return x.astype(np.float32)


def _ref(fn, x, w, *extra):
    xt = paddle.to_tensor(x, stop_gradient=False)
    ext = [paddle.to_tensor(e, stop_gradient=False) for e in extra]
    y = fn(xt, *ext)
    (y * paddle.to_tensor(np.asarray(w, np.float32))).sum().backward()
    return (y.numpy(), xt.grad.numpy()) + tuple(e.grad.numpy() for e in ext)


def _port(fn, x, w, *extra):
    xt = torch.tensor(x, requires_grad=True)
    ext = [torch.tensor(e, requires_grad=True) for e in extra]
    y = fn(xt, *ext)
    (y * torch.from_numpy(np.asarray(w, np.float32))).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy()) + tuple(
        e.grad.numpy() for e in ext)


def _check(got, want, what):
    """(value, gradients...) of the port against the reference's."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, err_msg=what,
                                   **(TOL if i == 0 else TOL_GRAD))


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_functional_matches_reference(name, kw):
    x = _input()
    out_shape = getattr(JF, name)(paddle.to_tensor(x), **kw).shape
    w = np.random.default_rng(1).standard_normal(out_shape)
    _check(_port(lambda a: getattr(TF, name)(a, **kw), x, w),
           _ref(lambda a: getattr(JF, name)(a, **kw), x, w), name)


@pytest.mark.parametrize("wshape,fmt", [((1,), "NCHW"), ((4,), "NCHW"),
                                        ((6,), "NHWC")])
def test_prelu_value_and_both_gradients(wshape, fmt):
    x = _input(2)
    wt = np.random.default_rng(3).uniform(0.1, 0.4, wshape).astype(np.float32)
    cot = np.random.default_rng(4).standard_normal(SHAPE)
    _check(_port(lambda a, b: TF.prelu(a, b, fmt), x, cot, wt),
           _ref(lambda a, b: JF.prelu(a, b, fmt), x, cot, wt), "prelu")


LAYERS = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid",
          "Hardsigmoid", "Hardswish", "Hardtanh", "Hardshrink", "Softshrink",
          "Tanhshrink", "LeakyReLU", "LogSigmoid", "Silu", "Swish", "Mish",
          "Softmax", "LogSoftmax", "Softplus", "Softsign", "Tanh",
          "ThresholdedReLU", "GLU"]


@pytest.mark.parametrize("cls", LAYERS)
def test_layer_at_defaults_matches_reference(cls):
    x = _input(5)
    want = getattr(jnn, cls)()(paddle.to_tensor(x)).numpy()
    got = getattr(tnn, cls)()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, err_msg=cls, **TOL)


def test_layers_with_arguments():
    x = _input(6)
    for j, t in ((jnn.Maxout(2, axis=1), tnn.Maxout(2, axis=1)),
                 (jnn.ELU(0.3), tnn.ELU(0.3)),
                 (jnn.Hardtanh(-2.0, 2.0), tnn.Hardtanh(-2.0, 2.0)),
                 (jnn.Softplus(3.0, 4.0), tnn.Softplus(3.0, 4.0)),
                 (jnn.Softmax(axis=2), tnn.Softmax(axis=2)),
                 (jnn.ReLU6(name="r"), tnn.ReLU6(name="r"))):
        np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(),
                                   j(paddle.to_tensor(x)).numpy(), **TOL)
    jp, tp = jnn.PReLU(4, init=0.2), tnn.PReLU(4, init=0.2, device="cpu")
    assert torch.equal(tp.weight, torch.full((4,), 0.2))
    np.testing.assert_allclose(tp(torch.from_numpy(x)).detach().numpy(),
                               jp(paddle.to_tensor(x)).numpy(), **TOL)


def test_hardsigmoid_keeps_the_reference_slope():
    x = torch.tensor([1.0])
    assert float(TF.hardsigmoid(x)) == pytest.approx(0.5 + 0.1666667, 1e-7)


def test_rrelu_training_draws_slopes_in_range():
    x = torch.from_numpy(_input(7))
    g = torch.Generator().manual_seed(0)
    y = TF.rrelu(x, 0.1, 0.3, training=True, generator=g)
    neg = x < 0
    slope = (y[neg] / x[neg])
    assert float(slope.min()) >= 0.1 and float(slope.max()) < 0.3
    assert torch.equal(y[~neg], x[~neg])
    assert torch.equal(y, TF.rrelu(x, 0.1, 0.3, training=True,
                                   generator=torch.Generator().manual_seed(0)))
    assert float(slope.std()) > 0.03           # drawn, not the mean


def test_gumbel_softmax():
    x = torch.from_numpy(_input(8)).requires_grad_()
    g = torch.Generator().manual_seed(1)
    soft = TF.gumbel_softmax(x, temperature=0.5, axis=1, generator=g)
    np.testing.assert_allclose(soft.sum(1).detach().numpy(), 1.0, atol=1e-6)
    hard = TF.gumbel_softmax(x, hard=True, generator=g)
    assert torch.equal(hard.detach().sum(-1), torch.ones(SHAPE[:-1]))
    assert set(torch.unique(hard.detach()).tolist()) <= {0.0, 1.0}
    hard.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    # the noise is Gumbel: the argmax of x + g hits each of 4 equal logits
    # about as often
    counts = torch.bincount(torch.argmax(TF.gumbel_softmax(
        torch.zeros(20000, 4), hard=True,
        generator=torch.Generator().manual_seed(2)), -1), minlength=4)
    assert float(counts.min()) > 4500 and float(counts.max()) < 5500
    want = JF.gumbel_softmax(paddle.to_tensor(np.zeros((20000, 4),
                                                        np.float32)),
                             hard=True).numpy().sum(0)
    assert want.min() > 4500 and want.max() < 5500


def test_in_place_variants():
    x = torch.from_numpy(_input(9))
    y = x.clone()
    assert TF.relu_(y) is y and torch.equal(y, torch.relu(x))
    z = x.clone()
    assert TF.tanh_(z) is z and torch.equal(z, torch.tanh(x))
