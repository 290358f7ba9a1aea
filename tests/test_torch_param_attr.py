"""``ParamAttr``, ``nn.initializer`` and ``regularizer`` of the port against
the reference on the CPU.

- ``ParamAttr``: the learning-rate scale, a parameter's regularizer
  winning over the optimizer's ``weight_decay``, ``trainable=False`` and
  the ``state_dict`` key set of named parameters, each after eager steps
  of both packages from the same weights (1e-6 absolute and relative);
  ``_to_attr``'s forms (None, False, an initializer, a name); every layer
  of the slice takes an attr; ``TransformerEncoder``'s clones keep their
  template's attrs and names, and a ``Parameter`` pickles with them.
- Initializers: ``Constant``, ``Assign`` and ``Dirac`` exactly; the random
  ones by the reference's fans, bounds and moments (the draws are
  torch's); ``Orthogonal`` by QᵀQ = I (1e-5).
- The frozen parameter under ``TrainStep`` is a divergence: the
  reference's functional path decays it with AdamW, the port's step
  leaves it (``test_frozen_parameter_under_trainstep``).
"""
import io
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as jinit
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.nn.initializer as tinit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_named_params

TOL = 1e-6


@pytest.fixture(autouse=True)
def _reference_env():
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    set_mesh(prev)


def _pair(attrs_j, attrs_t):
    """A two-layer MLP in each package (attrs: weight1, bias1, weight2,
    bias2), the same weights."""
    class J(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(4, 8, attrs_j[0], attrs_j[1])
            self.fc2 = jnn.Linear(8, 2, attrs_j[2], attrs_j[3])

        def forward(self, x):
            return self.fc2(JF.tanh(self.fc1(x)))

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = tnn.Linear(4, 8, attrs_t[0], attrs_t[1], device="cpu")
            self.fc2 = tnn.Linear(8, 2, attrs_t[2], attrs_t[3], device="cpu")

        def forward(self, x):
            return self.fc2(TF.tanh(self.fc1(x)))
    rng = np.random.default_rng(0)
    j, t = J(), T()
    init = {n: (0.5 * rng.standard_normal(p.shape)).astype(np.float32)
            for n, p in j.named_parameters()}
    for n, p in j.named_parameters():
        p._data = jnp.asarray(init[n])
    return j, load_named_params(t, init)


def _loss_j(m, x, y):
    return ((m(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()


def _loss_t(m, x, y):
    return ((m(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


def _train_both(j, t, make_opt, steps=3):
    jo = make_opt(jopt, jreg, j.parameters())
    to = make_opt(topt, treg, list(t.parameters()))
    rng = np.random.default_rng(1)
    for _ in range(steps):
        x = rng.standard_normal((6, 4)).astype(np.float32)
        y = rng.standard_normal((6, 2)).astype(np.float32)
        _loss_j(j, x, y).backward()
        jo.step()
        jo.clear_grad()
        _loss_t(t, x, y).backward()
        to.step()
        to.clear_grad()
    return jo, to


def _check_params(j, t):
    want = {n: np.asarray(p._data) for n, p in j.named_parameters()}
    for n, p in t.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=TOL,
                                   rtol=TOL, err_msg=n)


def _attrs(mod, extra=None):
    """Four named attrs; ``extra`` {index: ParamAttr keywords}."""
    extra = extra or {}
    return [mod.ParamAttr(name=f"p{i}", **extra.get(i, {}))
            for i in range(4)]


def test_learning_rate_scale():
    scale = {0: {"learning_rate": 0.5}, 3: {"learning_rate": 2.0}}
    j, t = _pair(_attrs(jnn, scale), _attrs(tnn, scale))
    before = {n: p.detach().clone() for n, p in t.named_parameters()}
    _train_both(j, t, lambda O, R, P: O.Momentum(0.1, 0.9, parameters=P))
    _check_params(j, t)
    assert t.fc1.weight.optimize_attr == {"learning_rate": 0.5}
    assert not torch.equal(before["fc1.weight"], t.fc1.weight)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_param_regularizer_wins_over_weight_decay(opt):
    """fc1's weight carries L1Decay(0.05), fc2's bias L2Decay(0.2); the
    optimizer's weight_decay L2Decay(0.01) decays the rest."""
    def attrs(mod, reg):
        return [mod.ParamAttr("w1", regularizer=reg.L1Decay(0.05)),
                mod.ParamAttr("b1"), mod.ParamAttr("w2"),
                mod.ParamAttr("b2", regularizer=reg.L2Decay(0.2))]
    j, t = _pair(attrs(jnn, jreg), attrs(tnn, treg))
    if opt == "sgd":
        def make(O, R, P):
            return O.SGD(0.1, parameters=P, weight_decay=R.L2Decay(0.01))
    else:
        def make(O, R, P):
            return O.Adam(0.05, parameters=P, weight_decay=R.L2Decay(0.01))
    _train_both(j, t, make)
    _check_params(j, t)


def test_regularizers_match_the_reference():
    x = np.random.default_rng(3).standard_normal((5, 3)).astype(np.float32)
    x[0, 0] = 0.0
    for cls in ("L1Decay", "L2Decay"):
        got = getattr(treg, cls)(0.3)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jreg, cls)(0.3)(jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)
        assert repr(getattr(treg, cls)(0.3)) == repr(getattr(jreg, cls)(0.3))


def test_frozen_parameter_is_not_updated_eagerly():
    frozen = {1: {"trainable": False}}
    j, t = _pair(_attrs(jnn, frozen), _attrs(tnn, frozen))
    b0 = t.fc1.bias.detach().clone()
    assert not t.fc1.bias.requires_grad and not t.fc1.bias.trainable
    _train_both(j, t, lambda O, R, P: O.AdamW(0.05, parameters=P,
                                              weight_decay=0.1))
    _check_params(j, t)
    assert torch.equal(t.fc1.bias, b0)


def test_frozen_parameter_under_trainstep():
    """Divergence: the reference's TrainStep updates every parameter, so
    AdamW moves a frozen one; the port's TrainStep updates only the
    parameters that require grad."""
    frozen = {1: {"trainable": False}}
    j, t = _pair(_attrs(jnn, frozen), _attrs(tnn, frozen))
    b0 = np.asarray(j.fc1.bias._data).copy()
    x = np.random.default_rng(4).standard_normal((6, 4)).astype(np.float32)
    y = np.zeros((6, 2), np.float32)
    JTrainStep(j, lambda m, a, b: ((m(a) - b) ** 2).mean(),
               jopt.AdamW(0.05, parameters=j.parameters(),
                          weight_decay=0.1))(paddle.to_tensor(x),
                                             paddle.to_tensor(y))
    assert not np.array_equal(np.asarray(j.fc1.bias._data), b0)
    TrainStep(t, lambda m, a, b: ((m(a) - b) ** 2).mean(),
              topt.AdamW(0.05, weight_decay=0.1))(torch.from_numpy(x),
                                                  torch.from_numpy(y))
    np.testing.assert_array_equal(t.fc1.bias.detach().numpy(), b0)


def test_state_dict_keys_of_named_parameters():
    j, t = _pair(_attrs(jnn), _attrs(tnn))
    jo, to = _train_both(j, t, lambda O, R, P: O.RMSProp(
        0.01, momentum=0.9, centered=True, parameters=P), steps=1)
    assert sorted(to.state_dict()) == sorted(jo.state_dict())
    assert "p0_mean_grad" in to.state_dict()


def test_to_attr_forms():
    assert tnn.ParamAttr._to_attr(None) is None
    assert tnn.ParamAttr._to_attr(False) is False
    a = tnn.ParamAttr._to_attr(tinit.Constant(2.0))
    assert isinstance(a.initializer, tinit.Constant)
    assert tnn.ParamAttr._to_attr("w").name == "w"
    with pytest.raises(TypeError):
        tnn.ParamAttr._to_attr(3)
    lin = tnn.Linear(3, 2, weight_attr=tinit.Constant(2.0), bias_attr=False,
                     device="cpu")
    assert torch.equal(lin.weight, torch.full((3, 2), 2.0))
    assert lin.bias is None and lin.weight.name.startswith(
        "generated_tensor_")
    assert pt.ParamAttr is tnn.ParamAttr


def test_every_layer_takes_an_attr():
    w = tnn.ParamAttr(initializer=tinit.Constant(0.5), learning_rate=0.1,
                      regularizer=treg.L2Decay(0.1))
    layers = [tnn.Linear(3, 4, w, w, device="cpu"),
              tnn.Embedding(5, 4, weight_attr=w, device="cpu"),
              tnn.Conv1D(2, 3, 3, weight_attr=w, bias_attr=w, device="cpu"),
              tnn.Conv2D(2, 3, 3, weight_attr=w, bias_attr=w, device="cpu"),
              tnn.Conv3D(2, 3, 1, weight_attr=w, bias_attr=w, device="cpu"),
              tnn.LayerNorm(4, weight_attr=w, bias_attr=w, device="cpu"),
              tnn.BatchNorm2D(3, weight_attr=w, bias_attr=w, device="cpu"),
              tnn.BatchNorm(3, param_attr=w, bias_attr=w, device="cpu"),
              tnn.PReLU(3, weight_attr=w, device="cpu"),
              tnn.LSTMCell(3, 4, weight_ih_attr=w, weight_hh_attr=w,
                           bias_ih_attr=w, bias_hh_attr=w, device="cpu"),
              tnn.MultiHeadAttention(4, 2, weight_attr=w, bias_attr=w,
                                     device="cpu")]
    for layer in layers:
        for n, p in layer.named_parameters():
            assert torch.all(p == 0.5), (type(layer).__name__, n)
            assert p.optimize_attr == {"learning_rate": 0.1}
            assert isinstance(p.regularizer, treg.L2Decay)


# -- initializers -------------------------------------------------------------

def _carried(p):
    reg = p.regularizer
    return (p.trainable, dict(p.optimize_attr), bool(p.is_bias),
            None if reg is None else (type(reg).__name__, float(reg.coeff)))


def test_transformer_encoder_clones_keep_param_carried():
    """TransformerEncoder deep-copies its template layer: every clone
    keeps each parameter's rate scale, regularizer, is_bias and trainable,
    and the clones share the template's names, as in the reference."""
    jw = paddle.ParamAttr(learning_rate=0.5, regularizer=jreg.L2Decay(0.1))
    tw = tnn.ParamAttr(learning_rate=0.5, regularizer=treg.L2Decay(0.1))
    jlayer = jnn.TransformerEncoderLayer(16, 2, 32, weight_attr=jw)
    tlayer = tnn.TransformerEncoderLayer(16, 2, 32, weight_attr=tw,
                                         device="cpu")
    jenc = jnn.TransformerEncoder(jlayer, 2)
    tenc = tnn.TransformerEncoder(tlayer, 2)
    jp, tp = dict(jenc.named_parameters()), dict(tenc.named_parameters())
    assert set(jp) == set(tp)
    decayed = 0
    for n in jp:
        assert _carried(tp[n]) == _carried(jp[n]), n
        decayed += tp[n].regularizer is not None
        # layers.0.x and layers.1.x carry the template's x's name
        rest = n.split(".", 2)[2]
        for pkg, layer in (("ref", jlayer), ("port", tlayer)):
            tmpl = dict(layer.named_parameters())[rest].name
            assert (jp if pkg == "ref" else tp)[n].name == tmpl, (pkg, n)
    assert decayed == 2 * 6        # q, k, v, out, linear1, linear2 weights
    # layer 0 is the template; layer 1 a clone with fresh storage, drawn
    # anew, not tied to it
    assert tenc.layers[0] is tlayer
    w1 = tenc.layers[1].linear1.weight
    assert w1.data_ptr() != tlayer.linear1.weight.data_ptr()
    assert not torch.equal(w1, tlayer.linear1.weight)


def test_parameter_pickles_with_its_carried():
    p = pt.framework.parameter.Parameter(
        torch.ones(3), trainable=False, name="w",
        regularizer=treg.L1Decay(0.25), learning_rate=0.5, is_bias=True)
    buf = io.BytesIO()
    torch.save({"p": p}, buf)
    buf.seek(0)
    q = torch.load(buf, weights_only=False)["p"]
    assert type(q) is type(p) and q.name == "w"
    assert _carried(q) == _carried(p) and not q.requires_grad
    assert torch.equal(q, p)


def test_calculate_gain_and_fans_match():
    for nl in ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu"):
        assert tinit.calculate_gain(nl) == jinit.calculate_gain(nl)
    assert tinit.calculate_gain("leaky_relu", 0.2) == \
        jinit.calculate_gain("leaky_relu", 0.2)
    for shape in ((7,), (3, 5), (8, 4, 3, 3), (6, 2, 5)):
        assert tinit._fan_in_out(shape) == jinit._fan_in_out(shape)


@pytest.mark.parametrize("case", ["constant", "assign", "dirac",
                                  "dirac_groups"])
def test_deterministic_initializers_exact(case):
    shape, j, t = {
        "constant": ((3, 4), jinit.Constant(0.7), tinit.Constant(0.7)),
        "assign": ((2, 3), jinit.Assign(np.arange(6.0)),
                   tinit.NumpyArrayInitializer(np.arange(6.0))),
        "dirac": ((4, 4, 3, 3), jinit.Dirac(), tinit.Dirac()),
        "dirac_groups": ((6, 3, 3), jinit.Dirac(2), tinit.Dirac(2)),
    }[case]
    got = t(shape, "float32", "cpu")
    want = np.asarray(j(shape, "float32"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _moments_ok(x, mean, std, n_sigma=5):
    n = x.numel()
    assert abs(float(x.mean()) - mean) < n_sigma * std / math.sqrt(n)
    assert abs(float(x.std()) - std) < n_sigma * std / math.sqrt(n / 2)


@pytest.mark.parametrize("shape", [(64, 256), (32, 16, 3, 3)])
def test_random_initializers_by_fan_bound_and_moments(shape):
    g = torch.Generator().manual_seed(0)
    fi, fo = jinit._fan_in_out(shape)
    # uniform families: the bound, and the moments of U(-a, a)
    for t, a in ((tinit.XavierUniform(), math.sqrt(6.0 / (fi + fo))),
                 (tinit.XavierUniform(gain=2.0),
                  2.0 * math.sqrt(6.0 / (fi + fo))),
                 (tinit.KaimingUniform(), math.sqrt(2.0) * math.sqrt(3.0 / fi)),
                 (tinit.Uniform(-0.3, 0.3), 0.3)):
        x = t(shape, "float32", "cpu", g)
        assert float(x.abs().max()) <= a and float(x.abs().max()) > 0.9 * a
        _moments_ok(x, 0.0, a / math.sqrt(3.0))
    for t, mean, std in (
            (tinit.XavierNormal(), 0.0, math.sqrt(2.0 / (fi + fo))),
            (tinit.KaimingNormal(), 0.0, math.sqrt(2.0) / math.sqrt(fi)),
            (tinit.MSRAInitializer(nonlinearity="leaky_relu",
                                   negative_slope=0.1),
             0.0, math.sqrt(2.0 / 1.01) / math.sqrt(fi)),
            (tinit.Normal(0.5, 2.0), 0.5, 2.0)):
        _moments_ok(t(shape, "float32", "cpu", g), mean, std)
    x = tinit.TruncatedNormal(1.0, 0.5)(shape, "float32", "cpu", g)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 2.0
    # a normal cut at 2 sigma keeps 0.8796 of its standard deviation
    _moments_ok(x, 1.0, 0.5 * 0.87962566)
    y = jinit.TruncatedNormal(1.0, 0.5)(shape)
    assert abs(float(jnp.std(y)) - float(x.std())) < 0.02


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 3, 2, 2)])
def test_orthogonal(shape):
    g = torch.Generator().manual_seed(1)
    q = tinit.Orthogonal(gain=1.5)(shape, "float32", "cpu", g)
    assert tuple(q.shape) == shape
    flat = q.reshape(shape[0], -1) / 1.5
    small = flat @ flat.T if flat.shape[0] <= flat.shape[1] else \
        flat.T @ flat
    np.testing.assert_allclose(small.numpy(), np.eye(small.shape[0]),
                               atol=1e-5)
    want = np.asarray(jinit.Orthogonal(gain=1.5)(shape)).reshape(
        shape[0], -1) / 1.5
    ws = want @ want.T if want.shape[0] <= want.shape[1] else want.T @ want
    np.testing.assert_allclose(ws, np.eye(ws.shape[0]), atol=1e-5)


def test_initializers_draw_from_the_generator_on_the_device():
    a = tinit.Normal()((4, 4), "float32", "cpu",
                       torch.Generator().manual_seed(7))
    b = tinit.Normal()((4, 4), "float32", "cpu",
                       torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.device.type == "cpu"
    p = tinit._create_param([3], attr=tnn.ParamAttr(
        "x", tinit.Constant(1.0), 0.5, treg.L1Decay(0.1), False),
        device="cpu")
    assert (p.name, p.trainable, p.requires_grad, p.is_bias) == (
        "x", False, False, False)
    assert p.optimize_attr == {"learning_rate": 0.5}
    assert tinit._create_param([2], is_bias=True, device="cpu").is_bias
