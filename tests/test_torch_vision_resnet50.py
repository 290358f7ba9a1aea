"""The port's resnet50 (paddle_tpu_torch.vision.models) against the
reference JAX model on the CPU, from the reference's weights and buffers
(by name), B=2 at 64x64:

- training mode, f32: the loss and every running stat after the forward
  (the batch's statistics, unbiased, with Paddle's momentum);
- evaluation mode, f64: the loss and the gradient of every parameter;
- the same model channel-last (NHWC) against channel-first (NCHW): the
  same training-mode loss and running stats, the same eval gradients.

Training-mode gradients of resnet50 at this size are not reproducible in
any precision: the port's f32 gradients differ from its own f64 ones by
up to 1.54 in the scaled measure below (median 0.052) at B=2, 64x64
(tools/f32_gradient_spread.py --model resnet50 --batch 2): the
last stage's BatchNorm normalises 8 values a channel and its backward
cancels nearly all of what reaches it.  In evaluation the norms are
affine, and the f64 gradients agree to rounding; the training-mode BN
backward is held by test_torch_vision_functional.py and resnet18's
trajectories (test_torch_vision.py).  At 32x32 the last BatchNorm would
normalise 2 values a channel, whose output is the sign of their
difference.

Tolerances: the f32 training forward's loss within 1e-3 and every running
stat by max |got - want| / (|want| + rms(want)) <= 1e-3 (53 BatchNorm
layers in f32, the last over 8 values); the f64 eval gradients by the
same measure <= 1e-9, the loss 1e-6 (the reference returns it in f32);
NHWC against the reference the same."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.vision import models as tmodels
from torch_vision_common import (as_dtype, batch, jloss, port,
                                 ref_call, scaled_err, set_state, state,
                                 tloss)

TOL_F32 = 1e-3
TOL_GRAD_F64 = 1e-9


@pytest.fixture(scope="module")
def r50():
    paddle.seed(0)
    ref = jmodels.resnet50(num_classes=10)
    return ref, state(ref), batch(2, 3, 64, 10, seed=5)


def _nchw_nhwc(x):
    xt = torch.from_numpy(x)
    return (("NCHW", xt), ("NHWC", xt.permute(0, 2, 3, 1).contiguous()))


def test_resnet50_train_forward(r50):
    """Training mode, f32: the loss and the running stats the forward
    left, channel-first and channel-last."""
    ref, (params, buffers), (x, y) = r50
    set_state(ref, params, buffers)
    want_loss, ref_stats = ref_call(ref, jloss, [x, y], new_buffers=True)
    for fmt, xt in _nchw_nhwc(x):
        model = port(tmodels.resnet50, params, buffers, num_classes=10,
                     data_format=fmt)
        loss = float(tloss(model, xt, torch.from_numpy(y)).detach())
        assert abs(loss - float(want_loss)) <= TOL_F32, fmt
        got = {n: b.numpy() for n, b in model.named_buffers()}
        assert sorted(got) == sorted(ref_stats)
        for n in ref_stats:
            err = scaled_err(got[n], ref_stats[n])
            assert err <= TOL_F32, f"{fmt} {n}: error {err:.3g}"


def test_resnet50_eval_gradients(r50):
    """Evaluation mode, f64: the loss and every gradient, channel-first and
    channel-last."""
    ref, (params, buffers), (x, y) = r50
    p64, b64 = as_dtype(params, np.float64), as_dtype(buffers, np.float64)
    set_state(ref, p64, b64)
    x64 = x.astype(np.float64)
    ref.eval()
    try:
        loss, grads = ref_call(ref, jloss, [x64, y], grad=True)
    finally:
        ref.train()
    for fmt, xt in _nchw_nhwc(x64):
        model = port(tmodels.resnet50, p64, b64, num_classes=10,
                     data_format=fmt)
        model.eval()
        got = tloss(model, xt, torch.from_numpy(y))
        got.backward()
        assert abs(float(got.detach()) - loss) <= 1e-6, fmt
        assert sorted(n for n, _ in model.named_parameters()) == sorted(grads)
        for n, p in model.named_parameters():
            err = scaled_err(p.grad.numpy(), grads[n])
            assert err <= TOL_GRAD_F64, f"{fmt} {n}: gradient error {err:.3g}"
