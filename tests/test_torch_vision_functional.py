"""The port's vision functionals (paddle_tpu_torch.nn.functional: conv,
pooling, batch_norm, cross_entropy) against the reference JAX functionals
on the CPU, from the same numpy inputs: values and the input gradients of
sum(out * w) for a fixed random w.

Tolerances: f32 values and gradients 1e-5 (absolute and relative: the
two packages sum in different orders).  bf16 cases by max |got - want| /
(|want| + rms(want)) <= 2e-2, a few bf16 roundings (8 bits) of the
tensor's scale: the two packages round the same sums at different steps
(XLA adds a bf16 reduction in bf16, PyTorch in f32), so a sum that
cancels to near 0 differs by the terms' rounding, not its own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = 2e-2


def _close(got, want, dtype, what=""):
    if dtype != "bf16":
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)
        return
    scale = np.abs(want) + np.sqrt(np.mean(np.square(want)))
    err = float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))
    assert err <= TOL_BF16, f"{what}: bf16 error {err:.3g} > {TOL_BF16}"


def _rng(seed):
    return np.random.default_rng(seed)


def _to_jax(a, dtype, diff):
    arr = jnp.asarray(a, jnp.bfloat16) if dtype == "bf16" else a
    return paddle.to_tensor(arr, stop_gradient=not diff)


def _to_torch(a, dtype, diff):
    t = torch.from_numpy(np.array(a))
    if dtype == "bf16" and t.is_floating_point():
        t = t.to(torch.bfloat16)
    return t.requires_grad_(diff)


def _f32(a):
    return np.asarray(a, np.float32)


def _compare(jfn, tfn, inputs, diff, dtype="f32", seed=99):
    """Run both on ``inputs`` (numpy), backward sum(out * w) and compare the
    outputs and the gradients of the inputs whose index is in ``diff``."""
    js = [_to_jax(a, dtype if a.dtype == np.float32 else "f32", i in diff)
          for i, a in enumerate(inputs)]
    ts = [_to_torch(a, dtype, i in diff) for i, a in enumerate(inputs)]
    out_j, out_t = jfn(*js), tfn(*ts)
    want = _f32(out_j._data)
    _close(_f32(out_t.detach().float()), want, dtype, "output")
    w = _rng(seed).standard_normal(want.shape).astype(np.float32)
    wj = paddle.to_tensor(jnp.asarray(w, out_j._data.dtype))
    (out_j * wj).sum().backward()
    (out_t * torch.from_numpy(w).to(out_t.dtype)).sum().backward()
    for i in diff:
        _close(_f32(ts[i].grad.float()), _f32(js[i].grad._data), dtype,
               f"gradient of input {i}")
    return out_t


# -- convolutions -------------------------------------------------------------

CONV2D = [
    # (stride, padding, dilation, groups, data_format)
    (1, 0, 1, 1, "NCHW"),
    (1, 1, 1, 1, "NCHW"),                         # int
    (1, [1, 2], 1, 1, "NCHW"),                    # per dim
    (1, [1, 0, 2, 1], 1, 1, "NCHW"),              # flat 2n, asymmetric
    (2, [(0, 1), (2, 0)], 1, 1, "NCHW"),          # pairs, asymmetric
    (2, "SAME", 1, 1, "NCHW"),                    # XLA's SAME at stride 2
    (1, "SAME", 2, 1, "NCHW"),                    # SAME with dilation
    (3, "SAME", 1, 1, "NCHW"),
    (1, "VALID", 1, 1, "NCHW"),
    (1, 2, 2, 1, "NCHW"),                         # dilation
    (2, 1, 1, 2, "NCHW"),                         # groups
    (2, "SAME", 1, 2, "NHWC"),
    (1, [1, 0, 2, 1], 1, 1, "NHWC"),
]


@pytest.mark.parametrize("stride,padding,dilation,groups,fmt", CONV2D)
def test_conv2d(stride, padding, dilation, groups, fmt):
    r = _rng(0)
    x = r.standard_normal((2, 4, 9, 11)).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w = r.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)
    _compare(lambda x, w, b: JF.conv2d(x, w, b, **kw),
             lambda x, w, b: TF.conv2d(x, w, b, **kw), [x, w, b], (0, 1, 2))


def test_conv2d_bf16():
    r = _rng(1)
    x = r.standard_normal((2, 4, 9, 9)).astype(np.float32)
    w = (r.standard_normal((6, 4, 3, 3)) * 0.3).astype(np.float32)
    kw = dict(stride=2, padding="SAME")
    out = _compare(lambda x, w: JF.conv2d(x, w, **kw),
                   lambda x, w: TF.conv2d(x, w, **kw), [x, w], (0, 1), "bf16")
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("fmt,padding", [("NCL", [1, 2]), ("NLC", "SAME"),
                                         ("NCL", "VALID")])
def test_conv1d(fmt, padding):
    r = _rng(2)
    x = r.standard_normal((2, 4, 13)).astype(np.float32)
    if fmt == "NLC":
        x = x.transpose(0, 2, 1).copy()
    w = r.standard_normal((5, 4, 3)).astype(np.float32)
    b = r.standard_normal(5).astype(np.float32)
    kw = dict(stride=2, padding=padding, data_format=fmt)
    _compare(lambda x, w, b: JF.conv1d(x, w, b, **kw),
             lambda x, w, b: TF.conv1d(x, w, b, **kw), [x, w, b], (0, 1, 2))


@pytest.mark.parametrize("fmt,padding", [("NCDHW", 1),
                                         ("NDHWC", [(1, 0), (0, 1), (1, 1)])])
def test_conv3d(fmt, padding):
    r = _rng(3)
    x = r.standard_normal((1, 3, 5, 6, 7)).astype(np.float32)
    if fmt == "NDHWC":
        x = x.transpose(0, 2, 3, 4, 1).copy()
    w = r.standard_normal((4, 3, 3, 3, 3)).astype(np.float32)
    kw = dict(stride=(1, 2, 1), padding=padding, data_format=fmt)
    _compare(lambda x, w: JF.conv3d(x, w, **kw),
             lambda x, w: TF.conv3d(x, w, **kw), [x, w], (0, 1))


# -- pooling ------------------------------------------------------------------

POOL = [
    # (kind, kernel, stride, padding, ceil_mode, exclusive, data_format, hw)
    ("max", 3, 2, 1, False, True, "NCHW", (9, 10)),   # ResNet's stem pool
    ("max", 2, 2, 0, False, True, "NCHW", (8, 8)),    # LeNet's
    ("max", 3, 2, [(0, 2), (1, 0)], False, True, "NCHW", (9, 10)),
    ("max", 3, 2, 1, True, True, "NCHW", (6, 9)),     # ceil: one more
    ("max", 2, 3, 1, True, True, "NCHW", (5, 8)),     # ceil: clamped
    ("max", 3, 2, "SAME", False, True, "NHWC", (9, 10)),
    ("avg", 3, 2, 1, False, True, "NCHW", (9, 10)),
    ("avg", 3, 2, 1, False, False, "NCHW", (9, 10)),
    ("avg", 3, 2, 1, True, True, "NCHW", (6, 9)),
    ("avg", 3, 2, 1, True, False, "NCHW", (6, 9)),
    ("avg", 2, 3, 1, True, True, "NHWC", (5, 8)),
    ("avg", 3, 2, "SAME", False, True, "NCHW", (9, 10)),
    ("avg", [2, 3], [1, 2], [1, 0, 0, 1], False, True, "NCHW", (7, 8)),
]


@pytest.mark.parametrize("kind,k,s,p,ceil,excl,fmt,hw", POOL)
def test_pool2d(kind, k, s, p, ceil, excl, fmt, hw):
    x = _rng(4).standard_normal((2, 3) + hw).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    if kind == "max":
        kw = dict(ceil_mode=ceil, data_format=fmt)
        jfn = lambda x: JF.max_pool2d(x, k, s, p, **kw)     # noqa: E731
        tfn = lambda x: TF.max_pool2d(x, k, s, p, **kw)     # noqa: E731
    else:
        kw = dict(ceil_mode=ceil, exclusive=excl, data_format=fmt)
        jfn = lambda x: JF.avg_pool2d(x, k, s, p, **kw)     # noqa: E731
        tfn = lambda x: TF.avg_pool2d(x, k, s, p, **kw)     # noqa: E731
    _compare(jfn, tfn, [x], (0,))


def test_pool2d_bf16():
    x = _rng(5).standard_normal((2, 3, 9, 9)).astype(np.float32)
    _compare(lambda x: JF.max_pool2d(x, 3, 2, 1),
             lambda x: TF.max_pool2d(x, 3, 2, 1), [x], (0,), "bf16")
    _compare(lambda x: JF.avg_pool2d(x, 3, 2, 1),
             lambda x: TF.avg_pool2d(x, 3, 2, 1), [x], (0,), "bf16")


def test_pool2d_refuses_what_it_does_not_port():
    """``return_mask`` is ported (tests/test_torch_pooling.py) and refuses
    only what the reference refuses (NHWC); ``divisor_override``, which
    the reference ignores, still raises."""
    x = torch.zeros(1, 1, 4, 4)
    out, mask = TF.max_pool2d(x, 2, return_mask=True)
    assert tuple(out.shape) == (1, 1, 2, 2) and mask.dtype == torch.int32
    with pytest.raises(ValueError, match="return_mask"):
        TF.max_pool2d(x, 2, return_mask=True, data_format="NHWC")
    with pytest.raises(NotImplementedError, match="divisor_override"):
        TF.avg_pool2d(x, 2, divisor_override=3)


@pytest.mark.parametrize("out,hw,fmt", [((1, 1), (7, 7), "NCHW"),
                                        (2, (6, 4), "NCHW"),
                                        ((3, 2), (7, 5), "NCHW"),
                                        ((3, None), (8, 5), "NHWC")])
def test_adaptive_avg_pool2d(out, hw, fmt):
    x = _rng(6).standard_normal((2, 3) + hw).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    _compare(lambda x: JF.adaptive_avg_pool2d(x, out, data_format=fmt),
             lambda x: TF.adaptive_avg_pool2d(x, out, data_format=fmt),
             [x], (0,))


# -- batch norm ---------------------------------------------------------------

BN = [
    # (training, use_global_stats, dtype, data_format, shape)
    (True, None, "f32", "NCHW", (4, 3, 5, 6)),
    (False, None, "f32", "NCHW", (4, 3, 5, 6)),
    (True, True, "f32", "NCHW", (4, 3, 5, 6)),
    (True, None, "f32", "NHWC", (4, 5, 6, 3)),
    (True, None, "f32", "NCHW", (8, 3)),
    (True, None, "bf16", "NCHW", (4, 3, 5, 6)),
    (True, None, "bf16", "NHWC", (4, 5, 6, 3)),
]


@pytest.mark.parametrize("training,ugs,dtype,fmt,shape", BN)
def test_batch_norm(training, ugs, dtype, fmt, shape):
    """Output, gradients of x, weight and bias, and the running stats
    after the update (f32 buffers in both packages)."""
    r = _rng(7)
    c = shape[-1] if fmt == "NHWC" else shape[1]
    x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * r.standard_normal(c)).astype(np.float32)
    b = (0.1 * r.standard_normal(c)).astype(np.float32)
    mean = (0.1 * r.standard_normal(c)).astype(np.float32)
    var = (1 + 0.1 * r.random(c)).astype(np.float32)
    rm_j, rv_j = paddle.to_tensor(mean), paddle.to_tensor(var)
    rm_t, rv_t = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    kw = dict(training=training, momentum=0.9, epsilon=1e-5,
              data_format=fmt, use_global_stats=ugs)
    _compare(lambda x, w, b: JF.batch_norm(x, rm_j, rv_j, w, b, **kw),
             lambda x, w, b: TF.batch_norm(x, rm_t, rv_t, w, b, **kw),
             [x, w, b], (0, 1, 2), dtype)
    assert rm_t.dtype == rv_t.dtype == torch.float32
    _close(rm_t.numpy(), _f32(rm_j._data), dtype, "running mean")
    _close(rv_t.numpy(), _f32(rv_j._data), dtype, "running variance")
    moved = training and not ugs
    assert moved == (not np.array_equal(rm_t.numpy(), mean))


def test_batch_norm_bf16_stats_add_into_f32_buffers():
    """A bf16 input's statistics add into f32 running stats with Paddle's
    momentum and the unbiased variance; the output stays bf16."""
    x = torch.from_numpy(_rng(8).standard_normal((4, 2, 3, 3)).astype(
        np.float32) + 3.0)
    rm, rv = torch.zeros(2), torch.ones(2)
    out = TF.batch_norm(x.bfloat16(), rm, rv, training=True)
    assert out.dtype == torch.bfloat16 and rm.dtype == torch.float32
    n = 4 * 3 * 3
    m = x.mean((0, 2, 3))
    v = x.var((0, 2, 3), unbiased=False) * n / (n - 1)
    np.testing.assert_allclose(rm.numpy(), 0.1 * m.numpy(), rtol=1e-2)
    np.testing.assert_allclose(rv.numpy(), 0.9 + 0.1 * v.numpy(), rtol=1e-2)


# -- cross entropy ------------------------------------------------------------

def _labels(n, c, shape, seed=9, ignore=None):
    lab = _rng(seed).integers(0, c, size=shape).astype(np.int64)
    if ignore is not None:
        lab.reshape(-1)[::3] = ignore
    return lab


CE = [
    # (label shape, kwargs)
    ((6,), {}),
    ((6, 1), {}),
    ((6,), {"ignore_index": 2}),
    ((6,), {"ignore_index": -1, "_ignore": -1}),
    ((6,), {"weight": True}),
    ((6,), {"weight": True, "ignore_index": -1, "_ignore": -1}),
    ((6,), {"weight": True, "reduction": "sum"}),
    ((6,), {"reduction": "none", "ignore_index": -1, "_ignore": -1}),
    ((6,), {"reduction": "sum"}),
    ((6,), {"use_softmax": False}),
    ((6, 4), {"axis": 1}),
    (None, {"soft_label": True}),
    (None, {"soft_label": True, "reduction": "none"}),
]


@pytest.mark.parametrize("lshape,kw", CE)
def test_cross_entropy(lshape, kw):
    kw = dict(kw)
    ignore = kw.pop("_ignore", None)
    r = _rng(10)
    c = 5
    axis = kw.get("axis", -1)
    shape = (6, c, 4) if axis == 1 else (6, c)
    logits = r.standard_normal(shape).astype(np.float32)
    if not kw.get("use_softmax", True):
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if kw.get("soft_label"):
        lab = r.random(shape).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = _labels(6, c, lshape, ignore=ignore)
    inputs = [logits, lab]
    if kw.pop("weight", False):
        inputs.append((0.5 + r.random(c)).astype(np.float32))
        jfn = lambda x, y, w: JF.cross_entropy(x, y, weight=w, **kw)  # noqa
        tfn = lambda x, y, w: TF.cross_entropy(x, y, weight=w, **kw)  # noqa
    else:
        jfn = lambda x, y: JF.cross_entropy(x, y, **kw)             # noqa
        tfn = lambda x, y: TF.cross_entropy(x, y, **kw)             # noqa
    _compare(jfn, tfn, inputs, (0,))


def test_cross_entropy_bf16():
    """Under O2 the logits are bf16 and so is the loss, in both."""
    r = _rng(11)
    logits = (r.standard_normal((8, 10)) * 3).astype(np.float32)
    lab = _labels(8, 10, (8,))
    out = _compare(lambda x, y: JF.cross_entropy(x, y),
                   lambda x, y: TF.cross_entropy(x, y), [logits, lab], (0,),
                   "bf16")
    assert out.dtype == torch.bfloat16


# -- layers -------------------------------------------------------------------

def test_layers_match_reference_names_shapes_and_init():
    """Conv2D's OIHW weight, Xavier-uniform with fan_in = in / groups *
    k*k and fan_out = out * k*k; BatchNorm's ones, zeros and its _mean /
    _variance buffers, under the reference's names."""
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch.nn as tnn
    pairs = [(jnn.Conv2D(4, 6, 3, groups=2), tnn.Conv2D(4, 6, 3, groups=2,
                                                        device="cpu")),
             (jnn.BatchNorm2D(5), tnn.BatchNorm2D(5, device="cpu")),
             (jnn.Conv1D(3, 2, 5, bias_attr=False),
              tnn.Conv1D(3, 2, 5, bias_attr=False, device="cpu"))]
    for ref, got in pairs:
        want = {n: tuple(p.shape) for n, p in ref.named_parameters()}
        assert {n: tuple(p.shape) for n, p in got.named_parameters()} == want
        want = {n: np.asarray(b._data) for n, b in ref.named_buffers()}
        have = {n: b.numpy() for n, b in got.named_buffers()}
        assert sorted(have) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(have[n], want[n])
    conv = tnn.Conv2D(4, 6, 3, groups=2, device="cpu")
    limit = np.sqrt(6.0 / (2 * 9 + 6 * 9))
    w = conv.weight.detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.8 * limit
    assert not conv.bias.detach().numpy().any()
    bn = tnn.BatchNorm2D(5, device="cpu")
    assert bn.weight.detach().numpy().tolist() == [1.0] * 5
    assert tnn.BatchNorm(5, device="cpu")._momentum == 0.9


def test_layers_refuse_what_they_do_not_port():
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.vision.models import resnet50
    with pytest.raises(NotImplementedError, match="padding_mode"):
        tnn.Conv2D(3, 4, 3, padding_mode="reflect", device="cpu")
    with pytest.raises(ValueError, match="does not support"):
        tnn.MaxPool2D(2, exclusive=True)
    with pytest.raises(ValueError, match="does not support"):
        tnn.AdaptiveAvgPool2D(1, ceil_mode=True)
    with pytest.raises(ValueError, match="pretrained"):
        resnet50(pretrained=True, device="cpu")


def test_vision_models_default_to_the_card(monkeypatch):
    from paddle_tpu_torch.vision.models import LeNet, resnet18
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (LeNet, resnet18):
        with pytest.raises(RuntimeError, match="is_available"):
            make()


def test_load_named_buffers_checks_names_and_shapes():
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.models import load_named_buffers
    bn = tnn.BatchNorm2D(3, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        load_named_buffers(bn, {"_mean": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_named_buffers(bn, {"_mean": np.zeros(4, np.float32),
                                "_variance": np.ones(3, np.float32)})
    load_named_buffers(bn, {"_mean": np.full(3, 2.0, np.float32),
                            "_variance": np.full(3, 3.0, np.float32)})
    assert bn._mean.tolist() == [2.0] * 3 and bn._variance.tolist() == [3.0] * 3
