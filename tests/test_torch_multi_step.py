"""``TrainStep.multi_step`` and ``FLAGS_check_nan_inf`` in the port against
K sequential calls and against the reference JAX ``TrainStep`` on the CPU.

- ``multi_step`` (both ``unroll`` values) is bitwise K calls of
  ``__call__``: losses, parameters, the global step; under O2 and with
  gradient merge too (``tests/test_jit.py`` ``TestMultiStep``).  Against
  the reference's ``multi_step`` from the same weights (carried by name):
  losses and parameters within 1e-5 and 1e-4 (the two sum in different
  orders).  The rate is read once a call.
- ``check_nan_inf`` armed: a non-finite loss raises ``FloatingPointError``;
  without donation every parameter, moment and buffer is as before the
  call, with donation the raise comes after the write-back; the global
  step does not move; ``multi_step`` likewise, one sweep over the K
  losses; armed, finite steps are bitwise the disarmed ones.  Disarmed, a
  NaN loss comes back without a raise and without a read from the device,
  as the reference returns it.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW

K = 4


class JSmallNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class SmallNet(torch.nn.Module):
    def __init__(self, norm=False):
        super().__init__()
        self.fc1 = tnn.Linear(8, 16, device="cpu")
        self.bn = tnn.BatchNorm1D(16, device="cpu") if norm else None
        self.fc2 = tnn.Linear(16, 4, device="cpu")

    def forward(self, x):
        h = self.fc1(x)
        if self.bn is not None:
            h = self.bn(h)
        return self.fc2(TF.relu(h))


def _weights(seed=0):
    paddle.seed(seed)
    ref = JSmallNet()
    return ref, {n: np.array(p._data) for n, p in ref.named_parameters()}


def _net(weights, norm=False):
    net = SmallNet(norm)
    if norm:
        weights = dict(weights, **{"bn.weight": np.ones(16, np.float32),
                                   "bn.bias": np.zeros(16, np.float32)})
    return load_named_params(net, weights)


def _data(seed=7, k=K, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, b, 8)).astype(np.float32),
            rng.normal(size=(k, b, 4)).astype(np.float32))


def _mse(model, xb, yb):
    return ((model(xb) - yb) ** 2).mean()


def _params(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def _sequential_and_multi(make_opt, unroll=False, k=K, **step_kw):
    _, w = _weights()
    xs, ys = _data(k=k)
    net_a, net_b = _net(w), _net(w)
    step_a = TrainStep(net_a, _mse, make_opt(), **step_kw)
    step_b = TrainStep(net_b, _mse, make_opt(), **step_kw)
    seq = torch.stack([step_a(xs[i], ys[i]) for i in range(k)])
    multi = step_b.multi_step(xs, ys, unroll=unroll)
    return (seq, net_a, step_a), (multi, net_b, step_b)


@pytest.mark.parametrize("unroll", [False, True])
def test_multi_step_matches_sequential_steps(unroll):
    (seq, net_a, _), (multi, net_b, step_b) = _sequential_and_multi(
        lambda: Adam(learning_rate=0.05), unroll=unroll)
    assert multi.shape == (K,) and multi.dtype == torch.float32
    assert torch.equal(multi, seq)
    _assert_equal(_params(net_b), _params(net_a))
    assert step_b.optimizer._global_step == K


def test_multi_step_amp_runs():
    (seq, net_a, _), (multi, net_b, _) = _sequential_and_multi(
        lambda: AdamW(learning_rate=1e-3), k=3, amp_level="O2",
        amp_dtype="bfloat16")
    assert multi.shape == (3,) and bool(torch.isfinite(multi).all())
    assert torch.equal(multi, seq)
    _assert_equal(_params(net_b), _params(net_a))


def test_multi_step_with_gradient_merge():
    (seq, net_a, _), (multi, net_b, _) = _sequential_and_multi(
        lambda: SGD(learning_rate=0.1), k=3, accumulate_steps=2)
    assert torch.equal(multi, seq)
    _assert_equal(_params(net_b), _params(net_a))


@pytest.mark.parametrize("unroll", [False, True])
def test_multi_step_matches_reference(unroll):
    ref, w = _weights(1)
    xs, ys = _data(11)
    jstep = jjit.TrainStep(ref, _mse, jopt.Adam(learning_rate=0.05,
                                                parameters=ref.parameters()))
    want = jstep.multi_step(paddle.to_tensor(xs), paddle.to_tensor(ys),
                            unroll=unroll)
    net = _net(w)
    step = TrainStep(net, _mse, Adam(learning_rate=0.05))
    got = step.multi_step(xs, ys, unroll=unroll)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=1e-5, rtol=0)
    got_p = _params(net)
    for n, p in ref.named_parameters():
        np.testing.assert_allclose(got_p[n].numpy(), np.asarray(p._data),
                                   atol=1e-4, rtol=0, err_msg=n)
    assert step.optimizer._global_step == K


def test_multi_step_reads_the_rate_once(monkeypatch):
    _, w = _weights()
    opt = Adam(learning_rate=0.05)
    reads = []
    get_lr = opt.get_lr
    monkeypatch.setattr(opt, "get_lr", lambda: reads.append(1) or get_lr())
    TrainStep(_net(w), _mse, opt).multi_step(*_data())
    assert len(reads) == 1


def test_multi_step_inputs_must_share_the_steps_axis():
    _, w = _weights()
    xs, ys = _data()
    with pytest.raises(ValueError, match="leading steps axis"):
        TrainStep(_net(w), _mse, Adam()).multi_step(xs, ys[:2])


@pytest.fixture
def armed():
    set_flags({"check_nan_inf": True})
    yield
    set_flags({"check_nan_inf": False})


def _poisoned(k=K):
    xs, ys = _data(k=k)
    xs[-1, 0, 0] = np.nan          # only the last step's loss is NaN
    return xs, ys


@pytest.mark.parametrize("donate", [False, True], ids=["copy", "donate"])
@pytest.mark.parametrize("multi", [False, True], ids=["call", "multi_step"])
def test_check_nan_inf_orders_the_raise_by_donation(armed, multi, donate):
    _, w = _weights()
    net = _net(w, norm=True)
    step = TrainStep(net, _mse, Adam(learning_rate=0.05), donate=donate)
    xs, ys = _data()
    step(xs[0], ys[0])                       # a finite step: state exists
    params, buffers = _params(net), {n: b.clone()
                                     for n, b in net.named_buffers()}
    states = {n: dict(st) for n, st in step._opt_states.items()}
    px, py = _poisoned()
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        step.multi_step(px, py) if multi else step(px[-1], py[-1])
    assert step.optimizer._global_step == 1
    if donate:
        # the raise came after the write-back: the NaN step's update
        assert not bool(torch.isfinite(net.fc1.weight).all())
        return
    _assert_equal(_params(net), params)
    _assert_equal({n: b for n, b in net.named_buffers()}, buffers)
    for n, st in step._opt_states.items():
        _assert_equal(st, states[n])
    # and the step goes on from there
    assert bool(torch.isfinite(step(xs[1], ys[1])))


@pytest.mark.parametrize("amp_level", [None, "O2"])
@pytest.mark.parametrize("donate", [False, True], ids=["copy", "donate"])
def test_check_nan_inf_armed_finite_steps_are_the_disarmed_ones(donate,
                                                                amp_level):
    """Armed without donation, a step carries its new parameters to the
    next step unwritten; finite steps must still be bitwise the disarmed
    ones: losses, parameters, moments and BatchNorm's buffers."""
    _, w = _weights()
    xs, ys = _data()
    got = []
    for armed in (True, False):
        set_flags({"check_nan_inf": armed})
        try:
            net = _net(w, norm=True)
            step = TrainStep(net, _mse, Adam(learning_rate=0.05),
                             donate=donate, amp_level=amp_level)
            losses = torch.cat([step(xs[0], ys[0])[None],
                                step.multi_step(xs[1:], ys[1:])])
        finally:
            set_flags({"check_nan_inf": False})
        got.append((losses, _params(net), dict(net.named_buffers()),
                    step._opt_states, step.optimizer._global_step))
    (la, pa, ba, sa, ga), (lb, pb, bb, sb, gb) = got
    assert torch.equal(la, lb) and ga == gb == K
    _assert_equal(pa, pb)
    _assert_equal(ba, bb)
    for n, st in sa.items():
        _assert_equal(st, sb[n])


def test_check_nan_inf_disarmed_returns_nan_without_a_read(monkeypatch):
    ref, w = _weights()
    px, py = _poisoned(2)
    want = jjit.TrainStep(ref, _mse, jopt.Adam(
        learning_rate=0.05, parameters=ref.parameters()))(
            paddle.to_tensor(px[-1]), paddle.to_tensor(py[-1]))
    assert np.isnan(float(want))
    step = TrainStep(_net(w), _mse, Adam(learning_rate=0.05))

    def no_read(*a, **k):
        raise AssertionError("the disarmed step read a value back")

    with monkeypatch.context() as m:
        for name in ("__bool__", "item", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, no_read)
        m.setattr(torch, "isfinite", no_read)
        loss = step(px[-1], py[-1])
        losses = step.multi_step(px, py)
    assert torch.isnan(loss) and bool(torch.isnan(losses[-1]))
    assert step.optimizer._global_step == 3
