"""The port's resnet18 through ``jit.TrainStep`` with ``accumulate_steps=2``
(f64) and under AMP O2 bf16 (f32 masters), against the reference JAX
``TrainStep`` on the CPU from the same state carried by name; tolerances
and the reason for f64 in tests/torch_vision_common.py.

- accumulate_steps=2 over B=8 at 64x64: the loss, the parameters after
  the one update, and every running stat after both micro-batches, which
  must equal the port's two forwards one after the other: micro-batch 2
  normalises by its own statistics and updates what micro-batch 1 left;
- O2 bf16, B=4 at 64x64: the first loss and the running stats after the
  first step; the buffers stay f32 and take no gradient, the masters f32;
- an eval() forward under the O2 cast (port only: the reference's raises)
  is finite and within a few bf16 roundings of the f32 forward.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.vision import models as tmodels
from torch_vision_common import (LR, TOL_LOSS_BF16, TOL_LOSS_F64, as_dtype,
                                 batch, check_buffers, check_params, jloss,
                                 momentum_step, port, set_state, state)


@pytest.fixture(scope="module")
def r18():
    paddle.seed(0)
    ref = jmodels.resnet18(num_classes=10)
    return ref, state(ref)


def _ref_step(ref, x, y, **kw):
    jstep = JTrainStep(ref, jloss, jopt.Momentum(
        learning_rate=LR, momentum=0.9, parameters=ref.parameters()), **kw)
    return float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))


def test_resnet18_accumulate_steps_threads_running_stats(r18):
    ref, init = r18
    params, buffers = (as_dtype(d, np.float64) for d in init)
    x, y = batch(8, 3, 64, 10, seed=4, dtype=np.float64)
    set_state(ref, params, buffers)
    want = _ref_step(ref, x, y, accumulate_steps=2)
    model = port(tmodels.resnet18, params, buffers, num_classes=10)
    got = float(momentum_step(model, accumulate_steps=2)(
        torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - want) <= TOL_LOSS_F64
    ref_params, ref_buffers = state(ref)
    check_params(model, ref_params)
    check_buffers(model, ref_buffers)
    two = port(tmodels.resnet18, params, buffers, num_classes=10)
    for k in range(2):
        two(torch.from_numpy(x[4 * k:4 * (k + 1)]))
    for (n, a), (_, b) in zip(model.named_buffers(), two.named_buffers()):
        assert torch.equal(a, b), n


def test_resnet18_o2_first_step(r18):
    ref, (params, buffers) = r18
    x, y = batch(4, 3, 64, 10, seed=3)
    set_state(ref, params, buffers)
    want = _ref_step(ref, x, y, amp_level="O2", amp_dtype="bfloat16")
    model = port(tmodels.resnet18, params, buffers, num_classes=10)
    got = float(momentum_step(model, amp_level="O2", amp_dtype="bfloat16")(
        torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - want) <= TOL_LOSS_BF16
    assert all(b.dtype == torch.float32 and not b.requires_grad
               for b in model.buffers())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    check_buffers(model, state(ref)[1], bf16=True)


def test_o2_eval_forward_normalises_in_the_input_dtype(r18):
    """An eval() forward under the O2 cast: the f32 running stats are cast
    to bf16 and normalise in it (the reference promotes the activation to
    f32 there and its next convolution refuses the mixed dtypes)."""
    from paddle_tpu_torch.jit import functional_loss_call
    _, (params, buffers) = r18
    model = port(tmodels.resnet18, params, buffers, num_classes=10)
    model.eval()
    x, _ = batch(2, 3, 64, 10, seed=6)
    with torch.no_grad():
        out = functional_loss_call(model, lambda m, xx: m(xx),
                                   dict(model.named_parameters()),
                                   [torch.from_numpy(x)], amp=True)
        want = model(torch.from_numpy(x))
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    # bf16 against f32: a few bf16 roundings of the logits' scale
    assert float((out - want).abs().max()) <= 0.05 * float(want.abs().max())
