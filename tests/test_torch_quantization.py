"""``quantization`` of the port against the reference on the CPU.

- The fake quantizers (per tensor, per channel, the moving-average
  observer) give the reference's values, and their straight-through
  gradient is the identity; ``ImperativeQuantAware`` swaps every Linear and
  a QAT forward and backward equal the reference's (1e-6).
- ``quant_post_weights`` / ``_quantize_weight``: the int8 codes and scales
  bitwise the reference's.
- ``Int8InferenceLinear`` / ``Int8InferenceConv2D``: the activation codes
  and the int32 accumulators bitwise those of the reference's own
  ``_quant_act`` and ``lax.dot_general`` / ``conv_general_dilated`` with
  an int32 accumulator, convolutions plain, strided, dilated, grouped,
  "SAME" and with K = 147 (ResNet's stem, padded to 152); outputs within
  1e-6 of the reference's layers.
- ``convert_to_int8_inference`` on a 32x32 ResNet-18 (seeded weights)
  swaps 20 convolutions and the fc, agrees with the float model on top-1
  as the reference's test asks (>= 0.75), and captures under
  ``to_static`` with the codes as constants.  (Building the reference's
  ResNet-18 costs some 20 s of per-shape compiles: its int8 layers are
  held to the port's one at a time above.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import quantization as jq
from paddle_tpu.nn.functional.conv import _norm_padding
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.vision.models import resnet18


@pytest.fixture(autouse=True)
def _cpu():
    prev = tdevice.get_device()
    tdevice.set_device("cpu")
    yield
    tdevice._default = prev


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t._data)


def _named(layer):
    return {n: np.array(p._data) for n, p in layer.named_parameters()}


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["abs_max", "channel_wise", "observer"])
def test_fake_quantizers_and_straight_through_gradient(kind):
    x = np.stack([np.linspace(-1, 1.27, 8),
                  np.linspace(-100, 100, 8)]).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    if kind == "abs_max":
        yj, yt = (jq.fake_quantize_dequantize_abs_max(jx),
                  tq.fake_quantize_dequantize_abs_max(tx))
    elif kind == "channel_wise":
        yj = jq.fake_channel_wise_quantize_dequantize_abs_max(jx,
                                                              quant_axis=0)
        yt = tq.fake_channel_wise_quantize_dequantize_abs_max(tx,
                                                              quant_axis=0)
    else:
        oj, ot = jq.MovingAverageAbsMaxObserver(0.5), \
            tq.MovingAverageAbsMaxObserver(0.5)
        oj.update(np.array([2.0], np.float32))
        ot.update(np.array([2.0], np.float32))
        assert ot.scale == oj.scale == 2.0
        yj, yt = oj.quantize(jx), ot.quantize(tx)
        assert ot.scale == pytest.approx(oj.scale, rel=1e-7)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-6, atol=1e-6)
    (yj * 3).sum().backward()
    (yt * 3).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.full(x.shape, 3.0))
    np.testing.assert_array_equal(_np(jx.grad), tx.grad.numpy())


@pytest.mark.parametrize("quant_axis", [-1, -2])
def test_channel_wise_negative_axis_takes_one_scale(quant_axis):
    """The reference reduces over every axis i != quant_axis, which a
    negative axis never equals: one scale for the whole tensor, the
    per-tensor quantizer's.  The port takes the axis as it is too."""
    rng = np.random.default_rng(3)
    x = (rng.uniform(-1, 1, (3, 4, 5))
         * np.geomspace(0.1, 1000, 5)).astype(np.float32)
    yj = _np(jq.fake_channel_wise_quantize_dequantize_abs_max(
        paddle.to_tensor(x), quant_axis=quant_axis))
    whole = _np(jq.fake_quantize_dequantize_abs_max(paddle.to_tensor(x)))
    np.testing.assert_array_equal(yj, whole)
    yt = _np(tq.fake_channel_wise_quantize_dequantize_abs_max(
        torch.from_numpy(x), quant_axis=quant_axis))
    # 2 f32 ulps at 1000, as on the positive axes
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1.25e-4)
    per_channel = _np(tq.fake_channel_wise_quantize_dequantize_abs_max(
        torch.from_numpy(x), quant_axis=quant_axis % 3))
    assert np.abs(per_channel - yj).max() > 1.0


def test_quant_aware_swap_forward_and_backward():
    class J(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(4, 8)
            self.inner = jnn.Sequential(jnn.Linear(8, 8), jnn.ReLU())
            self.fc2 = jnn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(self.inner(JF.relu(self.fc1(x))))

    class T(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = tnn.Linear(4, 8)
            self.inner = tnn.Sequential(tnn.Linear(8, 8), tnn.ReLU())
            self.fc2 = tnn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(self.inner(TF.relu(self.fc1(x))))

    paddle.seed(0)
    ref = J()
    port = load_named_params(T(), _named(ref))
    ref = jq.ImperativeQuantAware().quantize(ref)
    port = tq.ImperativeQuantAware().quantize(port)
    for m in (port.fc1, port.fc2, port.inner[0]):
        assert isinstance(m, tq.QuantizedLinear)
    for seed in (1, 2):
        x = _x((16, 4), seed)
        yj, yt = ref(paddle.to_tensor(x)), port(torch.from_numpy(x))
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=1e-6)
    (yj ** 2).sum().backward()
    (yt ** 2).sum().backward()
    for (n, pj), (_, pt) in zip(ref.named_parameters(),
                                port.named_parameters()):
        np.testing.assert_allclose(pt.grad.numpy(), _np(pj.grad), rtol=0,
                                   atol=1e-5, err_msg=n)


def test_post_training_weight_codes_bitwise():
    paddle.seed(1)
    ref = jnn.Sequential(jnn.Linear(6, 8), jnn.ReLU(), jnn.Linear(8, 3))
    port = load_named_params(
        tnn.Sequential(tnn.Linear(6, 8), tnn.ReLU(), tnn.Linear(8, 3)),
        _named(ref))
    pj, pt = jq.quant_post_weights(ref), tq.quant_post_weights(port)
    assert list(pj) == list(pt) == ["0.weight", "2.weight"]
    for n in pj:
        assert pt[n]["int"].dtype == np.int8
        np.testing.assert_array_equal(pt[n]["int"], pj[n]["int"])
        np.testing.assert_array_equal(pt[n]["scale"], pj[n]["scale"])
    for n, w in tq.dequant_weights(pt).items():
        np.testing.assert_array_equal(w, jq.dequant_weights(pj)[n])


def _ref_conv_acc(x, q, stride, padding, dilation, groups):
    """The reference layer's int32 accumulator, by its own code."""
    a_q, s_x = jq._quant_act(jnp.asarray(x))
    wq = jnp.asarray(q, jnp.int8)
    dn = jax.lax.conv_dimension_numbers(x.shape, wq.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    s = (stride,) * 2 if isinstance(stride, int) else stride
    d = (dilation,) * 2 if isinstance(dilation, int) else dilation
    acc = jax.lax.conv_general_dilated(
        a_q, wq, window_strides=s, padding=_norm_padding(padding, 2),
        rhs_dilation=d, dimension_numbers=dn, feature_group_count=groups,
        preferred_element_type=jnp.int32)
    return np.asarray(a_q), np.asarray(acc), float(s_x)


def test_int8_linear_codes_and_accumulators_bitwise():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((33, 20)).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    x = _x((5, 7, 33), 4, 3.0)
    q, scale = jq._quantize_weight(w)
    tq_, tscale = tq._quantize_weight(w)
    np.testing.assert_array_equal(tq_, q)
    np.testing.assert_array_equal(tscale, scale)
    a_q, s_x = jq._quant_act(jnp.asarray(x))
    ta_q, ts_x = tq._quant_act(torch.from_numpy(x))
    np.testing.assert_array_equal(ta_q.numpy(), np.asarray(a_q))
    assert float(ts_x) == float(s_x)
    want = np.asarray(jax.lax.dot_general(
        a_q, jnp.asarray(q, jnp.int8), (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    layer = tq.Int8InferenceLinear(q, scale, b)
    acc, _ = layer.accumulate(torch.from_numpy(x))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    out = layer(torch.from_numpy(x))
    ref = jq.Int8InferenceLinear(q, scale, b)(paddle.to_tensor(x))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    # the bf16 path returns bf16, as the reference's astype
    assert layer(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("cin,cout,k,stride,padding,dilation,groups", [
    (3, 8, 3, 1, 1, 1, 1),
    (3, 16, 7, 2, 3, 1, 1),            # ResNet's stem: K = 147
    (8, 12, 3, 2, 1, 1, 2),            # grouped and strided
    (4, 8, 3, 1, "SAME", 2, 1),        # dilated, XLA's SAME
    (8, 8, 1, 2, 0, 1, 4)])
def test_int8_conv_accumulators_bitwise(cin, cout, k, stride, padding,
                                        dilation, groups):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((cout, cin // groups, k, k)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    x = _x((2, cin, 11, 11), 6)
    q, scale = jq._quantize_weight(w, out_axis=0)
    a_q, want, s_x = _ref_conv_acc(x, q, stride, padding, dilation, groups)
    layer = tq.Int8InferenceConv2D(q, scale, b, stride=stride,
                                   padding=padding, dilation=dilation,
                                   groups=groups)
    acc, ts_x = layer.accumulate(torch.from_numpy(x))
    assert float(ts_x) == s_x and acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    ref = jq.Int8InferenceConv2D(q, scale, b, stride=stride,
                                 padding=padding, dilation=dilation,
                                 groups=groups)(paddle.to_tensor(x))
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), _np(ref),
                               rtol=1e-6, atol=1e-5)


def test_int8_layers_keep_their_codes_out_of_the_state_dict():
    q, scale = tq._quantize_weight(_x((8, 4), 7))
    layer = tq.Int8InferenceLinear(q, scale, np.zeros(4, np.float32))
    assert list(layer.state_dict()) == []
    layer.to(torch.bfloat16)
    assert layer._w_q.dtype == torch.int8
    assert layer._w_scale.dtype == torch.float32


def test_resnet18_int8_deploy_pass():
    torch.manual_seed(0)
    port = resnet18(num_classes=10, device="cpu")
    port.eval()
    x = _x((4, 3, 32, 32), 7)
    f32 = port(torch.from_numpy(x)).detach()
    qnet = tq.convert_to_int8_inference(port)

    def count(m, cls):
        return sum(isinstance(s, cls) for s in m.modules())
    assert count(qnet, tq.Int8InferenceConv2D) == 20
    assert count(qnet, tq.Int8InferenceLinear) == 1
    assert count(qnet, tnn.Conv2D) == 0
    out = qnet(torch.from_numpy(x))
    agree = float((out.argmax(1) == f32.argmax(1)).float().mean())
    assert agree >= 0.75, agree
    rel = float((out - f32).abs().max() / f32.abs().max())
    assert rel < 0.25, rel
    captured = tjit.to_static(qnet)
    assert torch.equal(captured(torch.from_numpy(x)), out)
    graph = next(iter(captured.forward._cache.values()))[0].graph
    assert any(str(n.target) == "aten._int_mm.default" for n in graph.nodes)
