"""The port's ten optimizers against the reference's on the CPU, eager and
functional, in f32.

Eager: a small MLP (4 -> 16 -> 3, tanh) whose parameters carry
``ParamAttr`` names, built in both packages from the same weights (carried
by name), trained 3 steps through ``loss.backward(); opt.step();
opt.clear_grad()`` on numpy-seeded batches; the parameters and every
``state_dict()`` entry are compared.  Functional: ``functional_update``
over the same numpy parameters and gradients for 3 steps.  Then
``state_dict`` -> ``set_state_dict`` resumes bitwise, a reference
``state_dict()`` loads into the port (``models.state_dict_from_jax``),
and the fused Adam's dispatch takes only the dtypes the optimizers make.

Tolerances: 1e-6 absolute plus 1e-6 relative on parameters and state; 1e-5
for LarsMomentum and Lamb, whose norms sum in another order.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
import jax.numpy as jnp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.models import load_named_params, state_dict_from_jax
from paddle_tpu_torch.ops.cuda import fused_adam as tfadam

TOL = 1e-6
TOL_NORMS = 1e-5
IN, HID, OUT, B = 4, 16, 3, 8
STEPS = 3

# name -> (optimizer of (optimizer module, regularizer module, params),
#          whether it has a functional path)
OPTS = {
    "sgd": (lambda O, R, P: O.SGD(0.1, parameters=P), True),
    "sgd_l2": (lambda O, R, P: O.SGD(0.1, parameters=P, weight_decay=0.01),
               True),
    "momentum_l2decay": (lambda O, R, P: O.Momentum(
        0.1, momentum=0.9, parameters=P, weight_decay=R.L2Decay(0.01)),
        True),
    "nesterov_l1decay": (lambda O, R, P: O.Momentum(
        0.1, momentum=0.9, parameters=P, use_nesterov=True,
        weight_decay=R.L1Decay(0.001)), True),
    "lars": (lambda O, R, P: O.LarsMomentum(
        0.1, momentum=0.9, parameters=P, lars_weight_decay=0.01,
        exclude_from_weight_decay=["fc2"]), True),
    "adam": (lambda O, R, P: O.Adam(0.01, parameters=P), True),
    "adamw": (lambda O, R, P: O.AdamW(0.01, parameters=P,
                                      weight_decay=0.1), True),
    "adamw_decay_fun": (lambda O, R, P: O.AdamW(
        0.01, parameters=P, weight_decay=0.1,
        apply_decay_param_fun=lambda n: n.endswith(".w")), False),
    "adamax": (lambda O, R, P: O.Adamax(0.01, parameters=P), True),
    "adagrad": (lambda O, R, P: O.Adagrad(
        0.1, parameters=P, initial_accumulator_value=0.1), True),
    "adadelta": (lambda O, R, P: O.Adadelta(1.0, parameters=P), True),
    "rmsprop": (lambda O, R, P: O.RMSProp(0.01, rho=0.9, momentum=0.9,
                                          parameters=P), True),
    "rmsprop_centered": (lambda O, R, P: O.RMSProp(
        0.01, rho=0.9, momentum=0.9, centered=True, parameters=P), True),
    "lamb": (lambda O, R, P: O.Lamb(0.01, parameters=P), True),
    "lamb_exclude": (lambda O, R, P: O.Lamb(
        0.01, parameters=P,
        exclude_from_weight_decay_fn=lambda p: p.name.endswith(".b")),
        False),
}


def _tol(name):
    return TOL_NORMS if name.startswith(("lars", "lamb")) else TOL


class JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(IN, HID, weight_attr=jnn.ParamAttr("fc1.w"),
                              bias_attr=jnn.ParamAttr("fc1.b"))
        self.fc2 = jnn.Linear(HID, OUT, weight_attr=jnn.ParamAttr("fc2.w"),
                              bias_attr=jnn.ParamAttr("fc2.b"))

    def forward(self, x):
        return self.fc2(JF.tanh(self.fc1(x)))


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(IN, HID, weight_attr=tnn.ParamAttr("fc1.w"),
                              bias_attr=tnn.ParamAttr("fc1.b"),
                              device="cpu")
        self.fc2 = tnn.Linear(HID, OUT, weight_attr=tnn.ParamAttr("fc2.w"),
                              bias_attr=tnn.ParamAttr("fc2.b"),
                              device="cpu")

    def forward(self, x):
        return self.fc2(TF.tanh(self.fc1(x)))


def _init(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"fc1.weight": (IN, HID), "fc1.bias": (HID,),
              "fc2.weight": (HID, OUT), "fc2.bias": (OUT,)}
    return {n: (0.5 * rng.standard_normal(s)).astype(np.float32)
            for n, s in shapes.items()}


def _batches(n=STEPS):
    rng = np.random.default_rng(1)
    return [(rng.standard_normal((B, IN)).astype(np.float32),
             rng.standard_normal((B, OUT)).astype(np.float32))
            for _ in range(n)]


def _models(init):
    ref = JMLP()
    for n, p in ref.named_parameters():
        p._data = jnp.asarray(init[n])
    return ref, load_named_params(TMLP(), init)


def _ref_train(ref, opt, batches):
    for x, y in batches:
        loss = ((ref(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()


def _port_train(port, opt, batches):
    for x, y in batches:
        loss = ((port(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.fixture(scope="module")
def ref_runs():
    """Each optimizer's reference eager run: (params, state_dict)."""
    out = {}
    for name, (make, _) in OPTS.items():
        ref, _ = _models(_init())
        opt = make(jopt, jreg, ref.parameters())
        _ref_train(ref, opt, _batches())
        out[name] = ({n: np.asarray(p._data)
                      for n, p in ref.named_parameters()},
                     {k: (v.numpy() if hasattr(v, "numpy") else v)
                      for k, v in opt.state_dict().items()})
    return out


@pytest.mark.parametrize("name", list(OPTS))
def test_eager_step_matches_reference(name, ref_runs):
    want_p, want_sd = ref_runs[name]
    _, port = _models(_init())
    opt = OPTS[name][0](topt, treg, list(port.parameters()))
    _port_train(port, opt, _batches())
    tol = _tol(name)
    for n, p in port.named_parameters():
        _close(p.detach().numpy(), want_p[n], tol, f"{name} {n}")
    got_sd = opt.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    assert got_sd["@global_step"] == want_sd["@global_step"] == STEPS
    for k, v in want_sd.items():
        if k == "@global_step":
            continue
        assert got_sd[k].dtype == torch.float32, k
        _close(got_sd[k].numpy(), v, tol, f"{name} {k}")


FUNCTIONAL = [n for n, (_, functional) in OPTS.items() if functional]


@pytest.mark.parametrize("name", FUNCTIONAL)
def test_functional_update_matches_reference(name):
    init = _init(2)
    params_r = {n: jnp.asarray(a) for n, a in init.items()}
    params_t = {n: torch.from_numpy(a.copy()) for n, a in init.items()}
    jo = OPTS[name][0](jopt, jreg, None)
    to = OPTS[name][0](topt, treg, None)
    st_r = jo.functional_init_states(params_r)
    st_t = to.functional_init_states(params_t)
    rng = np.random.default_rng(5)
    for _ in range(STEPS):
        g = {n: rng.standard_normal(a.shape).astype(np.float32)
             for n, a in init.items()}
        params_r, st_r = jo.functional_update(
            params_r, {n: jnp.asarray(a) for n, a in g.items()}, st_r)
        params_t, st_t = to.functional_update(
            params_t, {n: torch.from_numpy(a) for n, a in g.items()}, st_t)
    tol = _tol(name)
    for n in init:
        _close(params_t[n].numpy(), params_r[n], tol, f"{name} {n}")
        assert sorted(st_t[n]) == sorted(st_r[n])
        for k in st_r[n]:
            assert str(st_t[n][k].dtype).replace("torch.", "") == \
                str(st_r[n][k].dtype), (n, k)
            _close(st_t[n][k].numpy(), st_r[n][k], tol, f"{name} {n} {k}")


@pytest.mark.parametrize("name", ["adamw_decay_fun", "lamb_exclude"])
def test_eager_only_options_raise_on_the_functional_path(name):
    opt = OPTS[name][0](topt, treg, None)
    p = {"fc1.w": torch.ones(2, 2)}
    with pytest.raises(NotImplementedError, match="eager step"):
        opt.functional_update(p, {"fc1.w": torch.ones(2, 2)},
                              opt.functional_init_states(p))


@pytest.mark.parametrize("name", ["adamw_decay_fun", "lamb_exclude"])
def test_reference_functional_path_ignores_the_eager_only_options(name):
    """Divergence: the reference's functional update decays every
    parameter whatever AdamW's apply_decay_param_fun or Lamb's
    exclude_from_weight_decay_fn say (only its eager step honours them);
    the port's functional path raises instead
    (test_eager_only_options_raise_on_the_functional_path)."""
    plain = {"adamw_decay_fun": "adamw", "lamb_exclude": "lamb"}[name]
    init = {"fc1.b": np.linspace(-1, 1, 6).astype(np.float32)}
    g = {"fc1.b": jnp.asarray(np.linspace(2, -1, 6).astype(np.float32))}
    got = []
    for which in (name, plain):
        jo = OPTS[which][0](jopt, jreg, None)
        p = {n: jnp.asarray(a) for n, a in init.items()}
        p, _ = jo.functional_update(p, g, jo.functional_init_states(p))
        got.append(np.asarray(p["fc1.b"]))
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("name", list(OPTS))
def test_state_dict_resumes_bitwise(name):
    batches = _batches(STEPS + 1)
    _, port = _models(_init())
    opt = OPTS[name][0](topt, treg, list(port.parameters()))
    _port_train(port, opt, batches[:STEPS])
    sd = opt.state_dict()
    snap = {n: p.detach().clone() for n, p in port.named_parameters()}
    _port_train(port, opt, batches[STEPS:])
    _, again = _models(_init())
    with torch.no_grad():
        for n, p in again.named_parameters():
            p.copy_(snap[n])
    opt2 = OPTS[name][0](topt, treg, list(again.parameters()))
    opt2.set_state_dict(sd)
    _port_train(again, opt2, batches[STEPS:])
    for (n, p), q in zip(port.named_parameters(), again.parameters()):
        assert torch.equal(p, q), f"{name} {n}"
    assert opt2.state_dict()["@global_step"] == STEPS + 1


def test_reference_state_dict_loads_into_the_port():
    """A reference Adam's eager state_dict() continues in the port: one more
    step from it matches the reference's one more step."""
    batches = _batches(STEPS + 1)
    ref, port = _models(_init())
    jo = jopt.Adam(0.01, parameters=ref.parameters())
    _ref_train(ref, jo, batches[:STEPS])
    sd = state_dict_from_jax({k: (v.numpy() if hasattr(v, "numpy") else v)
                              for k, v in jo.state_dict().items()})
    with torch.no_grad():
        for n, p in port.named_parameters():
            p.copy_(torch.from_numpy(np.array(
                dict(ref.named_parameters())[n]._data)))
    to = topt.Adam(0.01, parameters=list(port.parameters()))
    to.set_state_dict(sd)
    _ref_train(ref, jo, batches[STEPS:])
    _port_train(port, to, batches[STEPS:])
    for n, p in port.named_parameters():
        _close(p.detach().numpy(), np.asarray(
            dict(ref.named_parameters())[n]._data), TOL, n)


def test_minimize_runs_the_backward_itself():
    """``minimize(loss)`` = backward + step, as the reference's."""
    x, y = _batches(1)[0]
    _, a = _models(_init())
    _, b = _models(_init())
    oa = topt.SGD(0.1, parameters=list(a.parameters()))
    ob = topt.SGD(0.1, parameters=list(b.parameters()))
    oa.minimize(((a(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean())
    _port_train(b, ob, [(x, y)])
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cls", [topt.Adam, topt.AdamW])
def test_fused_adam_gets_only_uniform_dtypes(cls, dtype):
    """The optimizers hand the fused pass all-f32 or all-bf16 (p, g, m, v):
    the state takes the parameter's dtype, the gradient is the
    parameter's; any other mix raises."""
    p = torch.nn.Parameter(torch.randn(10, dtype=dtype))
    opt = cls(0.01, parameters=[p], use_fused=True)
    p.grad = torch.randn(10, dtype=dtype)
    opt.step()
    st = opt._state_for(p)
    assert {t.dtype for t in st.values()} == {dtype}
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    args = [[torch.zeros(8, dtype=dtype)] for _ in range(4)]
    args[2] = [torch.zeros(8, dtype=other)]              # m of another dtype
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tfadam.fused_adam(*args, torch.ones(1), torch.zeros(()), 0.9,
                          0.999, 1e-8)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tfadam.fused_adam(*[[torch.zeros(8, dtype=torch.float16)]] * 4,
                          torch.ones(1), torch.zeros(()), 0.9, 0.999, 1e-8)


def test_adam_beta_pows_follow_the_parameter_and_adamax_lamb_stay_f32():
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.zeros(3, dtype=dtype)
        assert topt.Adam().init_state(v)["beta1_pow"].dtype == dtype
        assert topt.Adamax().init_state(v)["beta1_pow"].dtype == \
            torch.float32
        assert topt.Lamb().init_state(v)["beta2_pow"].dtype == torch.float32
        acc = topt.Adagrad(0.1, initial_accumulator_value=0.25).init_state(v)
        assert torch.equal(acc["moment"], torch.full((3,), 0.25,
                                                     dtype=dtype))
