"""ResNet-GN (Wu & He, Group Normalization, ECCV 2018: every BatchNorm2D
of a ResNet replaced by GroupNorm(32, C)) through ``jit.TrainStep``
against the reference on the CPU.  Neither package's ResNet takes a norm
layer, so both swap the sublayers after construction through the
``Layer`` API (``named_sublayers``, then ``setattr`` on the parent), as
``chip_smoke.py``'s resnet50-gn phase does.  resnet18(num_classes=10), B=2
at 32x32, in float64 for the reason ``torch_vision_common.py`` gives (the
statistics still accumulate in f32 in both): 2 Momentum steps, losses
within 1e-5 and every parameter and velocity by ``rel_close`` at 1e-5."""
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jmodels
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.vision import models as tmodels
from torch_vision_common import (TOL_LOSS_F64, LR, as_dtype, batch, jloss,
                                 momentum_step, port, rel_close, set_state,
                                 state)


def group_norm_swap(model, nn, **kw):
    """Every BatchNorm2D sublayer of ``model`` replaced, by name, with
    GroupNorm(32, its channels)."""
    layers = dict(model.named_sublayers(include_self=True))
    for name, layer in list(layers.items()):
        if isinstance(layer, nn.BatchNorm2D):
            parent, _, attr = name.rpartition(".")
            setattr(layers[parent], attr,
                    nn.GroupNorm(32, layer.weight.shape[0], **kw))
    return model


def test_resnet18_gn_momentum_trainstep():
    paddle.seed(0)
    ref = group_norm_swap(jmodels.resnet18(num_classes=10), jnn)
    assert not dict(ref.named_buffers())
    params, buffers = (as_dtype(d, np.float64) for d in state(ref))
    set_state(ref, params, buffers)
    model = port(lambda **kw: group_norm_swap(
        tmodels.resnet18(**kw), tnn, device="cpu"), params, buffers,
        num_classes=10)
    names = [n for n, _ in model.named_parameters()]
    assert names == list(params) and "layer2.0.downsample.1.weight" in names
    assert sum(isinstance(m, tnn.GroupNorm) for m in model.sublayers()) == 20
    x, y = batch(2, 3, 32, 10, seed=4, dtype=np.float64)
    jstep = JTrainStep(ref, jloss, jopt.Momentum(
        learning_rate=LR, momentum=0.9, parameters=ref.parameters()))
    tstep = momentum_step(model)
    for _ in range(2):
        want = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        got = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(got - want) <= TOL_LOSS_F64
        for n, p in ref.named_parameters():
            rel_close(dict(model.named_parameters())[n].detach().numpy(),
                      np.asarray(p._data), n)
        for n, st in tstep._opt_states.items():
            rel_close(st["velocity"].numpy(),
                      np.asarray(jstep._opt_states[n]["velocity"]),
                      f"{n}.velocity")
