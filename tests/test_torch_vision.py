"""The port's LeNet and resnet18 (paddle_tpu_torch.vision.models) and their
training through ``jit.TrainStep``, BatchNorm's running stats included,
against the reference JAX models on the CPU, from the same state carried
by name (tests/torch_vision_common.py states the tolerances and why the
resnet trajectories run in float64):

- LeNet (B=8, 1x28x28, f32): logits and gradients, then 3
  ``TrainStep(Adam(1e-3))`` steps: losses, parameters and moments;
- resnet18(num_classes=10), B=4 at 64x64, f64: 2 ``TrainStep(Momentum)``
  steps at lr 1e-3 (losses, parameters, velocities, every ``_mean`` and
  ``_variance``); the second step again from the reference's state after
  the first (``opt_states_from_jax`` with Momentum's velocity); an f32
  eval forward on the running stats the steps left.

At 32x32 the last stage's BatchNorm would normalise B * 1 * 1 = 4 values
a channel, nearly the sign of differences between nearly equal values;
64x64 gives it 16.  accumulate_steps and AMP O2 are in
test_torch_vision_o2.py, resnet50 in test_torch_vision_resnet50.py."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import opt_states_from_jax
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.vision import models as tmodels
from torch_vision_common import (LR, TOL, TOL_LOSS_F64, as_dtype, batch,
                                 check_buffers, check_grads, check_params,
                                 jloss, logits, momentum_step, port,
                                 ref_call, rel_close, set_state, state,
                                 tloss)


# -- LeNet --------------------------------------------------------------------

@pytest.fixture(scope="module")
def lenet():
    paddle.seed(0)
    ref = jmodels.LeNet(num_classes=10)
    return ref, state(ref)


def test_lenet_logits_and_gradients(lenet):
    ref, (params, buffers) = lenet
    x, y = batch(8, 1, 28, 10, seed=1)
    model = port(tmodels.LeNet, params, buffers)
    want = ref_call(ref, logits, [x])
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               want, **TOL)
    loss, grads = ref_call(ref, jloss, [x, y], grad=True)
    got = tloss(model, torch.from_numpy(x), torch.from_numpy(y))
    got.backward()
    assert abs(float(got.detach()) - loss) <= 1e-5
    check_grads(model, grads)


def test_lenet_adam_trainstep(lenet):
    ref, (params, buffers) = lenet
    x, y = batch(8, 1, 28, 10, seed=2)
    model = port(tmodels.LeNet, params, buffers)
    set_state(ref, params, buffers)
    jstep = JTrainStep(ref, jloss, jopt.Adam(learning_rate=1e-3,
                                             parameters=ref.parameters()))
    tstep = TrainStep(model, tloss, Adam(learning_rate=1e-3))
    for _ in range(3):
        want = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        got = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(got - want) <= 1e-5
    check_params(model, state(ref)[0])
    for n, st in tstep._opt_states.items():
        for k in ("moment1", "moment2"):
            rel_close(st[k].numpy(), np.asarray(jstep._opt_states[n][k]),
                      f"{n}.{k}")


# -- resnet18 -----------------------------------------------------------------

@pytest.fixture(scope="module")
def r18():
    """The reference resnet18's initial state in f64, and its Momentum run
    from it: (loss, params, buffers, opt states) after each of 2 steps."""
    paddle.seed(0)
    ref = jmodels.resnet18(num_classes=10)
    init = [as_dtype(d, np.float64) for d in state(ref)]
    set_state(ref, *init)
    x, y = batch(4, 3, 64, 10, seed=3, dtype=np.float64)
    jstep = JTrainStep(ref, jloss, jopt.Momentum(
        learning_rate=LR, momentum=0.9, parameters=ref.parameters()))
    run = []
    for _ in range(2):
        loss = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        run.append((loss,) + state(ref) + (
            {n: {k: np.asarray(a) for k, a in st.items()}
             for n, st in jstep._opt_states.items()},))
    return ref, init, (x, y), run


def _check_run_state(model, tstep, want):
    loss, params, buffers, states = want
    check_params(model, params)
    for n, st in tstep._opt_states.items():
        rel_close(st["velocity"].numpy(), states[n]["velocity"],
                  f"{n}.velocity")
    check_buffers(model, buffers)


def test_resnet18_momentum_trainstep(r18):
    """Two steps: losses, parameters, velocities, every running stat."""
    ref, init, (x, y), run = r18
    model = port(tmodels.resnet18, *init, num_classes=10)
    tstep = momentum_step(model)
    for want in run:
        got = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(got - want[0]) <= TOL_LOSS_F64
        _check_run_state(model, tstep, want)


def test_resnet18_continues_from_reference_state(r18):
    """Step 2 from the reference's parameters, running stats and Momentum
    velocity after step 1."""
    ref, _, (x, y), run = r18
    _, params, buffers, states = run[0]
    model = port(tmodels.resnet18, params, buffers, num_classes=10)
    tstep = momentum_step(model)
    tstep.set_opt_states({n: {k: v.double() for k, v in st.items()}
                          for n, st in opt_states_from_jax(states).items()})
    got = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - run[1][0]) <= TOL_LOSS_F64
    _check_run_state(model, tstep, run[1])


def test_resnet18_eval_forward(r18):
    """eval(): the running stats the two steps left normalise, in f32 (a
    forward is continuous, so rounding cannot flip it); the buffers stay
    as they were and the output differs from the training-mode one."""
    ref, _, (x, _), run = r18
    x = x.astype(np.float32)
    params, buffers = (as_dtype(d, np.float32) for d in run[1][1:3])
    set_state(ref, params, buffers)
    ref.eval()
    try:
        want = ref_call(ref, logits, [x])
    finally:
        ref.train()
    model = port(tmodels.resnet18, params, buffers, num_classes=10)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for n, b in model.named_buffers():
        assert np.array_equal(b.numpy(), buffers[n]), n
    model.train()
    with torch.no_grad():
        assert not np.allclose(model(torch.from_numpy(x)).numpy(), got,
                               atol=1e-3)
