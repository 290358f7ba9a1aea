"""A tiny detector (``torch_yolov3_common``: three convolutions, a DCNv2
block, two YOLOv3 heads, 64x64, B=2) in the port against the same model
in the reference on the CPU, the weights carried by name: the f32 loss
and every gradient, then one step of ``Momentum(1e-3, 0.9)`` in f64 (the
loss, every gradient and every parameter after the step).

Tolerances: f32 loss 1e-5 relative, gradients max |got - want| / (|want|
+ rms(want)) 1e-4; f64 the same measures at 1e-9 (LeakyReLU's f32 kinks
and the ignore mask's IoU threshold could flip between two f32
implementations; in f64 they do not)."""
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.vision import ops as jops
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.vision import ops as tops
from torch_yolov3_common import CLASSES, detector, loss

B, HW, GT, REAL = 2, 64, 6, 4
LR = 1e-3


def _models(dtype):
    paddle.seed(0)
    jm = detector(jnn, JF, jops)
    params = {n: np.asarray(p._data).astype(dtype)
              for n, p in jm.named_parameters()}
    for n, p in jm.named_parameters():
        p._data = paddle.to_tensor(params[n])._data
    tm = detector(tnn, TF, tops, device="cpu")
    if dtype == np.float64:
        tm = tm.double()
    return jm, load_named_params(tm, params)


def _batch(dtype):
    """Images, then gt boxes (xywh pixels) with REAL real rows an image,
    one padding row of label -1 and the rest of width 0, and labels."""
    r = np.random.default_rng(1)
    x = r.standard_normal((B, 3, HW, HW)).astype(dtype)
    box = np.zeros((B, GT, 4), dtype)
    box[:, :REAL, :2] = r.uniform(4, HW - 4, (B, REAL, 2))
    box[:, :REAL, 2:] = r.uniform(6, 50, (B, REAL, 2))
    box[:, REAL, 2:] = 12.0
    label = r.integers(0, CLASSES, (B, GT)).astype(np.int32)
    label[:, REAL] = -1
    return x, box, label


def _scaled(got, want):
    scale = np.abs(want) + np.sqrt(np.mean(np.square(want)))
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))


def _loss_and_grads(dtype, tol):
    jm, tm = _models(dtype)
    x, box, label = _batch(dtype)
    lj = loss(jops, jm(paddle.to_tensor(x)), paddle.to_tensor(box),
              paddle.to_tensor(label))
    lt = loss(tops, tm(torch.from_numpy(x)), torch.from_numpy(box),
              torch.from_numpy(label))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=tol)
    lj.backward()
    lt.backward()
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(n for n, _ in jm.named_parameters())
    for n, p in jm.named_parameters():
        err = _scaled(named[n].grad.numpy(), np.asarray(p.grad._data))
        assert err <= tol, f"gradient of {n}: {err:.3g}"
    return jm, tm


def test_f32_loss_and_gradients_match_reference():
    _loss_and_grads(np.float32, 1e-4)


def test_f64_momentum_step_matches_reference():
    jm, tm = _loss_and_grads(np.float64, 1e-9)
    before = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    jopt.Momentum(learning_rate=LR, momentum=0.9,
                  parameters=jm.parameters()).step()
    topt.Momentum(learning_rate=LR, momentum=0.9,
                  parameters=tm.parameters()).step()
    named = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        want = np.asarray(p._data)
        assert np.abs(want - before[n]).max() > 0, f"{n} did not move"
        got = named[n].detach().numpy()
        err = float(np.abs(got - want).max()
                    / (np.abs(want - before[n]).max() + LR))
        assert err <= 1e-9, f"move of {n}: {err:.3g}"
