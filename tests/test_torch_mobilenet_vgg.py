"""MobileNetV1, MobileNetV2 and VGG-11 with BatchNorm of the port
(vision/models/{mobilenet,vgg}.py) against the reference on the CPU:
the same parameter and buffer names, then a training-mode forward (the
logits and every running stat the forward leaves) and every parameter's
gradient of the cross-entropy, from the reference's weights carried by
name; the reference runs jitted (``tests/torch_vision_common.py``).  The
dropouts of the heads are switched to evaluation in both packages, so
that the training forward is deterministic.  The gradients are taken in
evaluation mode, as test_torch_vision_resnet50.py takes ResNet-50's: in
training mode the last stages normalise 8 values a channel (B=2, 2x2),
whose f32 statistics (both packages' rule, in f64 too) summed in two
orders move MobileNetV1's gradients by up to 0.4 in the measure below.

MobileNets at scale 0.25, B=2 at 64x64, in float64 (ReLU kinks, see
torch_vision_common); VGG-11 with BN, B=2 at 32x32 (its 1x1 feature map
pooled adaptively to 7x7 for the full 25088-4096-4096 head), in f32.
Tolerances are torch_vision_common's: outputs and running stats 1e-4
(f32) or 1e-5 (f64) of their scale, gradients 1e-3 by
``max |got - want| / (|want| + rms(want))``.

MobileNetV2 under the recipe the card trains it with (RMSProp(0.045,
rho=0.9, momentum=0.9), L2Decay(4e-5), GradScaler): one eager step of the
port against the reference's update from the reference's gradients, in
f64 and evaluation mode (the parameters' moves within 1e-5 of the move);
and the first steps in f32 and training mode, where the loss rises by
more than 5x after the first step in both packages (RMSProp's first step
moves a weight by up to lr / sqrt(1 - rho), about 0.14).  The two
training-mode trajectories agree on the first loss only: the last stages
normalise 8 values a channel, and the differences of f32 summation order
there grow over the steps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jmodels
import paddle_tpu_torch.amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.vision import models as tmodels
from torch_vision_common import (as_dtype, batch, check_grads, jloss,
                                 logits, port, ref_call, rel_close, set_state,
                                 state, tloss)

CASES = {
    "mobilenet_v1": (dict(scale=0.25, num_classes=10), 64, np.float64),
    "mobilenet_v2": (dict(scale=0.25, num_classes=10), 64, np.float64),
    "vgg11_bn": (dict(batch_norm=True, num_classes=10), 32, np.float32),
}


def _make(pkg, name, **kw):
    fn = name[:-3] if name.endswith("_bn") else name
    return getattr(pkg, fn)(**kw)


def _no_dropout(ref, model):
    for m in ref.sublayers():
        if isinstance(m, jnn.Dropout):
            m.eval()
    for m in model.modules():
        if isinstance(m, torch.nn.Module) and type(m).__name__ == "Dropout":
            m.eval()


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    name = request.param
    kw, hw, dtype = CASES[name]
    paddle.seed(0)
    ref = _make(jmodels, name, **kw)
    params, buffers = (as_dtype(d, dtype) for d in state(ref))
    set_state(ref, params, buffers)
    model = port(lambda **k: _make(tmodels, name, **kw, **k), params,
                 buffers)
    _no_dropout(ref, model)
    x, y = batch(2, 3, hw, 10, seed=4, dtype=dtype)
    return name, ref, model, params, buffers, x, y


def test_names_match_the_reference(pair):
    _, ref, model, params, buffers, _, _ = pair
    assert [n for n, _ in model.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in model.named_buffers()] == \
        [n for n, _ in ref.named_buffers()]


def test_training_forward_and_running_stats(pair):
    name, ref, model, _, _, x, y = pair
    ref.train()
    model.train()
    _no_dropout(ref, model)
    want, want_bufs = ref_call(ref, logits, [x], new_buffers=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    rel_close(got.numpy(), want, f"{name} logits")
    for n, b in model.named_buffers():
        rel_close(b.numpy(), want_bufs[n], f"{name} {n}")


def test_gradients(pair):
    name, ref, _, params, buffers, x, y = pair
    ref.eval()
    set_state(ref, params, buffers)
    model = port(lambda **k: _make(tmodels, name, **CASES[name][0], **k),
                 params, buffers).eval()
    want_loss, want_grads = ref_call(ref, jloss, [x, y], grad=True)
    model.zero_grad()
    loss = tloss(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= 1e-4 * (
        abs(want_loss) + 0.1)
    check_grads(model, want_grads)


def _rmsprop(pkg, reg, params=None):
    return pkg.RMSProp(0.045, rho=0.9, momentum=0.9, parameters=params,
                       weight_decay=reg.L2Decay(4e-5))


def _mobilenet_v2_pair(dtype):
    paddle.seed(0)
    ref = jmodels.mobilenet_v2(scale=0.25, num_classes=10)
    params, buffers = (as_dtype(d, dtype) for d in state(ref))
    set_state(ref, params, buffers)
    model = port(lambda **k: tmodels.mobilenet_v2(scale=0.25, num_classes=10,
                                                  **k), params, buffers)
    _no_dropout(ref, model)
    return ref, model, params


def test_rmsprop_recipe_step_matches_reference():
    """One eager step of the port (GradScaler.minimize, RMSProp with
    momentum, L2Decay) against the reference's RMSProp update applied to
    the reference's gradients, f64, evaluation mode."""
    ref, model, params = _mobilenet_v2_pair(np.float64)
    ref.eval()
    model.eval()
    x, y = batch(2, 3, 32, 10, seed=4, dtype=np.float64)
    _, grads = ref_call(ref, jloss, [x, y], grad=True)
    jo = _rmsprop(jopt, jreg)
    want, _ = jax.jit(lambda p, g: jo.functional_update(
        p, g, jo.functional_init_states(p)))(
        {n: jnp.asarray(a) for n, a in params.items()},
        {n: jnp.asarray(g) for n, g in grads.items()})
    to = _rmsprop(topt, treg, list(model.parameters()))
    scaler = tamp.GradScaler()
    scaler.minimize(to, scaler.scale(
        tloss(model, torch.from_numpy(x), torch.from_numpy(y))))
    assert scaler._scale == 2.0 ** 15
    for n, p in model.named_parameters():
        move = np.asarray(want[n]) - params[n]
        err = np.abs(p.detach().numpy() - np.asarray(want[n])).max()
        assert np.abs(move).max() > 0, n
        assert err <= 1e-5 * np.abs(move).max(), (n, err)


def test_rmsprop_recipe_first_steps_rise_in_both_packages():
    """The loss after the first step is more than 5x the first in the
    reference (TrainStep, jitted) and in the port (the eager loop), as
    on the card at full size."""
    ref, model, _ = _mobilenet_v2_pair(np.float32)
    x, y = batch(8, 3, 32, 10, seed=4)
    step = JTrainStep(ref, jloss, _rmsprop(jopt, jreg,
                                           ref.parameters()))
    want = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
            for _ in range(2)]
    opt = _rmsprop(topt, treg, list(model.parameters()))
    got = []
    for _ in range(2):
        loss = tloss(model, torch.from_numpy(x), torch.from_numpy(y))
        opt.minimize(loss)
        opt.clear_grad()
        got.append(float(loss.detach()))
    assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    assert want[1] > 5 * want[0] and got[1] > 5 * got[0], (want, got)
