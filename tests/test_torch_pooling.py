"""The port's pools (``max/avg_pool{1,2,3}d``, the adaptive pools, the
masked max pools and ``max_unpool2d``, and their layers) against the
reference on the CPU, from the same numpy inputs: the output, the mask
(bitwise, int32) and the input gradient of sum(out * w) for a fixed
random w.

The tie cases hold the reference's gradient rules: a masked or adaptive
max pool splits a window's gradient among its tied maxima (0.25 each on
an all-zero 4 x 4 input in 2 x 2 windows, and on ReLU'd inputs), the
unmasked max pool gives it to the first.  Every case the reference
refuses, the port refuses with the same error; ``divisor_override`` and a
channel-last ``max_unpool2d``, which the reference ignores, raise in the
port.  Tolerance: f32 values and gradients 1e-5 absolute and relative."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _run(jfn, tfn, x, seed=5):
    """Both functions on x: the port's (out, mask, input gradient) held to
    the reference's; a mask is held bitwise.  Returns the port's."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    oj, ot = jfn(jx), tfn(tx)
    mj = mt = None
    if isinstance(oj, tuple):
        (oj, mj), (ot, mt) = oj, ot
        want = np.asarray(mj._data)
        assert mt.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(mt.numpy(), want, err_msg="mask")
    want = np.asarray(oj._data)
    np.testing.assert_allclose(ot.detach().numpy(), want, **TOL,
                               err_msg="output")
    w = _rng(seed).standard_normal(want.shape).astype(np.float32)
    (oj * paddle.to_tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               **TOL, err_msg="gradient")
    return ot, mt, tx.grad


def _x(shape, seed=0, relu=False):
    a = _rng(seed).standard_normal(shape).astype(np.float32)
    return np.maximum(a, 0) if relu else a


def _both(name, *args, **kw):
    return (lambda t: getattr(JF, name)(t, *args, **kw),
            lambda t: getattr(TF, name)(t, *args, **kw))


POOLS = [
    # (functional, input shape, args, kwargs)
    ("max_pool1d", (2, 3, 11), (3,), dict(stride=2, padding=1)),
    ("max_pool1d", (2, 3, 10), (3,), dict(stride=2, ceil_mode=True)),
    ("max_pool1d", (2, 11, 3), (2,), dict(data_format="NLC")),
    ("avg_pool1d", (2, 3, 11), (3,), dict(stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 11), (3,),
     dict(stride=2, padding=1, exclusive=False, ceil_mode=True)),
    ("avg_pool1d", (2, 10, 3), (4,), dict(stride=3, padding="SAME",
                                          data_format="NLC")),
    ("max_pool3d", (2, 3, 5, 6, 7), (3,), dict(stride=2, padding=1)),
    ("max_pool3d", (2, 3, 5, 6, 7), (2,), dict(ceil_mode=True)),
    ("max_pool3d", (2, 5, 6, 7, 3), (2,), dict(stride=[1, 2, 2],
                                               data_format="NDHWC")),
    ("avg_pool3d", (2, 3, 5, 6, 7), (3,), dict(stride=2, padding=1)),
    ("avg_pool3d", (2, 3, 5, 6, 7), ([2, 3, 2],),
     dict(stride=2, padding=[0, 1, 1, 0, 1, 2], exclusive=False)),
    ("avg_pool3d", (2, 5, 6, 7, 3), (2,), dict(ceil_mode=True,
                                               data_format="NDHWC")),
    ("max_pool2d", (2, 3, 7, 8), (3,), dict(stride=2, padding=1)),
    ("avg_pool2d", (2, 3, 7, 8), (3,), dict(stride=2, padding="VALID")),
    ("adaptive_avg_pool1d", (2, 3, 10), (4,), {}),
    ("adaptive_avg_pool3d", (2, 3, 4, 6, 7), ([2, None, 3],), {}),
    ("adaptive_avg_pool3d", (2, 4, 6, 7, 3), (2,),
     dict(data_format="NDHWC")),
    ("adaptive_max_pool1d", (2, 3, 10), (4,), {}),
    ("adaptive_max_pool1d", (2, 3, 12), (4,), {}),
    ("adaptive_max_pool2d", (2, 3, 7, 9), ([3, 4],), {}),
    ("adaptive_max_pool2d", (2, 3, 8, 8), (2,), {}),
    ("adaptive_max_pool3d", (2, 3, 4, 6, 7), ([2, 3, None],), {}),
]


@pytest.mark.parametrize("relu", [False, True], ids=["randn", "relu"])
@pytest.mark.parametrize("case", POOLS, ids=lambda c: c[0])
def test_pool_matches_reference(case, relu):
    """Values and gradients; on ReLU'd inputs the max pools meet tied
    zeros (the adaptive max pools split them, the unmasked ones give the
    first the whole)."""
    name, shape, args, kw = case
    _run(*_both(name, *args, **kw), _x(shape, len(name), relu))


MASKED = [
    ("max_pool2d", (2, 3, 8, 8), (2,), {}),
    ("max_pool2d", (2, 3, 9, 10), (3,), dict(stride=2, padding=1)),  # stem
    ("max_pool2d", (2, 3, 9, 10), (3,), dict(stride=2, ceil_mode=True)),
    ("max_pool2d", (2, 3, 9, 10), ([3, 2],),
     dict(stride=[2, 3], padding=[1, 0, 2, 1], ceil_mode=True)),
    ("max_pool1d", (2, 3, 11), (3,), dict(stride=2, padding=1)),
    ("max_pool1d", (2, 11, 3), (3,), dict(stride=2, data_format="NLC",
                                          ceil_mode=True)),
    ("adaptive_max_pool1d", (2, 3, 12), (4,), {}),
    ("adaptive_max_pool2d", (2, 3, 8, 12), ([4, None],), {}),
    ("adaptive_max_pool2d", (2, 3, 8, 12), (2,), {}),
]


@pytest.mark.parametrize("relu", [False, True], ids=["randn", "relu"])
@pytest.mark.parametrize("case", MASKED, ids=lambda c: c[0])
def test_masked_pool_matches_reference(case, relu):
    """The mask bitwise, the values, and the gradient split among tied
    maxima (ReLU'd inputs tie at 0 in many windows)."""
    name, shape, args, kw = case
    _run(*_both(name, *args, return_mask=True, **kw),
         _x(shape, len(name), relu))


def test_tied_windows_split_the_gradient():
    """All-zero 4 x 4 input, 2 x 2 windows: the masked and the adaptive
    max pool give every cell 0.25, the unmasked pool 1.0 to each window's
    first cell; the mask names the first cell of each window."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    first = np.zeros((4, 4), np.float32)
    first[::2, ::2] = 1.0
    for fn, want in ((lambda t: TF.max_pool2d(t, 2, return_mask=True)[0],
                      np.full((4, 4), 0.25, np.float32)),
                     (lambda t: TF.adaptive_max_pool2d(t, 2),
                      np.full((4, 4), 0.25, np.float32)),
                     (lambda t: TF.max_pool2d(t, 2), first)):
        t = torch.from_numpy(x.copy()).requires_grad_()
        fn(t).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy()[0, 0], want)
    _, mask, _ = _run(*_both("max_pool2d", 2, return_mask=True), x)
    np.testing.assert_array_equal(mask.numpy()[0, 0], [[0, 2], [8, 10]])
    _run(*_both("adaptive_max_pool2d", 2), x)
    _run(*_both("max_pool2d", 2), x)


UNPOOL = [
    # (input shape, kernel, stride, padding, output_size)
    ((2, 3, 8, 8), 2, None, 0, None),
    ((2, 3, 9, 10), 3, 2, 1, None),
    ((2, 3, 9, 10), 3, 2, 1, [9, 10]),
    ((2, 3, 8, 8), 2, 2, 0, [1, 1, 9, 9]),
]


@pytest.mark.parametrize("relu", [False, True], ids=["randn", "relu"])
@pytest.mark.parametrize("case", UNPOOL, ids=range(len(UNPOOL)))
def test_max_unpool2d_matches_reference(case, relu):
    """max_pool2d(return_mask) then max_unpool2d: the scattered map and the
    gradient through both."""
    shape, k, s, p, size = case

    def chain(F):
        def fn(t):
            out, mask = F.max_pool2d(t, k, s, p, return_mask=True)
            return F.max_unpool2d(out, mask, k, s, p, output_size=size)
        return fn
    _run(chain(JF), chain(TF), _x(shape, 3, relu))


def test_max_unpool2d_last_duplicate_wins():
    """Two windows of a 3 x 3, stride-1 pool record one index: the last
    in flattened order takes the value and the gradient, in both."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 1, 1] = 5.0
    mask = np.zeros((1, 1, 2, 2), np.int32) + 5
    v = _rng(2).standard_normal((1, 1, 2, 2)).astype(np.float32)
    jv = paddle.to_tensor(v, stop_gradient=False)
    tv = torch.from_numpy(v.copy()).requires_grad_()
    oj = JF.max_unpool2d(jv, paddle.to_tensor(mask), 3, 1, 0)
    ot = TF.max_unpool2d(tv, torch.from_numpy(mask), 3, 1, 0)
    np.testing.assert_array_equal(ot.detach().numpy(), np.asarray(oj._data))
    assert float(ot.detach()[0, 0, 1, 1]) == float(v[0, 0, 1, 1])
    w = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    (oj * paddle.to_tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jv.grad._data))
    np.testing.assert_array_equal(tv.grad.numpy()[0, 0], [[0, 0], [0, 5]])


RAISES = [
    ("max_pool2d", (1, 4, 4, 2), (2,),
     dict(return_mask=True, data_format="NHWC"), ValueError),
    ("max_pool2d", (1, 2, 4, 4), (2,),
     dict(return_mask=True, padding="SAME"), ValueError),
    ("max_pool3d", (1, 2, 4, 4, 4), (2,), dict(return_mask=True),
     NotImplementedError),
    ("adaptive_max_pool3d", (1, 2, 4, 4, 4), (2,), dict(return_mask=True),
     NotImplementedError),
    ("adaptive_max_pool1d", (1, 2, 10), (4,), dict(return_mask=True),
     NotImplementedError),
    ("adaptive_max_pool2d", (1, 2, 6, 7), (3,), dict(return_mask=True),
     NotImplementedError),
]


@pytest.mark.parametrize("case", RAISES, ids=lambda c: c[0])
def test_refused_where_the_reference_refuses(case):
    name, shape, args, kw, err = case
    x = np.zeros(shape, np.float32)
    with pytest.raises(err):
        getattr(JF, name)(paddle.to_tensor(x), *args, **kw)
    with pytest.raises(err):
        getattr(TF, name)(torch.from_numpy(x), *args, **kw)


@pytest.mark.parametrize("name,shape", [("avg_pool2d", (1, 2, 4, 4)),
                                        ("avg_pool3d", (1, 2, 4, 4, 4))])
def test_divisor_override_raises_where_the_reference_ignores_it(name,
                                                                shape):
    x = np.ones(shape, np.float32)
    ref = getattr(JF, name)(paddle.to_tensor(x), 2, divisor_override=3)
    np.testing.assert_array_equal(np.asarray(ref._data), 1.0)
    with pytest.raises(NotImplementedError, match="divisor_override"):
        getattr(TF, name)(torch.from_numpy(x), 2, divisor_override=3)


def test_max_unpool2d_takes_nchw_only():
    x = torch.zeros(1, 2, 2, 2)
    with pytest.raises(NotImplementedError, match="NCHW"):
        TF.max_unpool2d(x, torch.zeros(1, 2, 2, 2, dtype=torch.int32), 2,
                        data_format="NHWC")


LAYERS = [
    ("MaxPool1D", (3,), dict(stride=2, padding=1), (2, 3, 11)),
    ("MaxPool2D", (3,), dict(stride=2, return_mask=True), (2, 3, 9, 9)),
    ("MaxPool3D", (2,), {}, (2, 3, 4, 6, 6)),
    ("AvgPool1D", (3,), dict(exclusive=False), (2, 3, 11)),
    ("AvgPool2D", (3,), dict(stride=2, ceil_mode=True), (2, 3, 9, 9)),
    ("AvgPool3D", (2,), dict(data_format="NDHWC"), (2, 4, 6, 6, 3)),
    ("AdaptiveAvgPool1D", (4,), {}, (2, 3, 10)),
    ("AdaptiveAvgPool2D", (3,), {}, (2, 3, 7, 8)),
    ("AdaptiveAvgPool3D", (2,), {}, (2, 3, 4, 5, 6)),
    ("AdaptiveMaxPool1D", (4,), dict(return_mask=True), (2, 3, 12)),
    ("AdaptiveMaxPool2D", (3,), {}, (2, 3, 7, 8)),
    ("AdaptiveMaxPool3D", (2,), {}, (2, 3, 4, 5, 6)),
]


@pytest.mark.parametrize("case", LAYERS, ids=lambda c: c[0])
def test_pool_layers_match_reference(case):
    name, args, kw, shape = case
    _run(getattr(jnn, name)(*args, **kw), getattr(tnn, name)(*args, **kw),
         _x(shape, len(name), relu=True))


def test_pool_layers_refuse_unknown_keywords():
    with pytest.raises(ValueError, match="does not support"):
        tnn.MaxPool1D(2, divisor_override=2)
    with pytest.raises(ValueError, match="does not support"):
        tnn.AdaptiveMaxPool2D(2, data_format="NHWC")
