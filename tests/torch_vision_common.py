"""Shared pieces of the vision tests (test_torch_vision*.py): the loss,
the reference and the port's models in one state carried by name
(models.load_named_params / load_named_buffers), the reference run
jitted (its TrainStep, or ``functional_loss_call`` under ``jax.jit``), and
the comparisons with their tolerances.

Why the deep models are compared in float64.  Two f32 implementations of
a ReLU network round differently, and a pre-activation within that
rounding of 0 takes the other side of the kink in one of them: the
gradients behind it move, by 2e-2 to 0.32 in the scaled measure below
(resnet18 at B=4, 64x64, the port's f32 gradients against its own f64
ones: 5 of 24 random states flipped one; python -m
paddle_tpu_torch.tools.f32_gradient_spread --device cpu).  In float64 both packages still
accumulate BatchNorm's statistics in f32 (the reference's rule, kept by
the port), so they differ by about 1e-7 and no flip was seen.  f32 is
held where it is well posed: the functionals (test_torch_vision_
functional.py), LeNet's trajectory, forwards, running stats, and the O2
bf16 step at a bf16 tolerance.

Tolerances:
- f32: outputs, losses and running stats 1e-4 absolute and relative;
  parameters and optimizer state ``max |got - want| <= 1e-4 * (max |want|
  + 0.1)``; gradients ``max |got - want| / (|want| + rms(want)) <= 1e-3``;
- f64 trajectories: the same measures at ``RTOL_F64`` = 1e-5 (BN
  statistics in f32: about 1e-7 a layer, over 20 layers); the losses,
  which both steps return in f32, within 1e-5;
- O2 bf16: the loss (itself bf16) within 3.2e-2, two bf16 steps of a loss
  in [2, 4); running stats by the gradients' scale-relative measure,
  <= 1e-2 at the stem's BN (two bf16 roundings: the statistic, then n / (n
  - 1)) and <= 5e-2 at every BN, the roundings compounding over 20
  layers."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import functional_loss_call
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_named_buffers, load_named_params
from paddle_tpu_torch.optimizer import Momentum

TOL = dict(rtol=1e-4, atol=1e-4)
RTOL_F64 = 1e-5
TOL_LOSS_F64 = 1e-5
TOL_GRAD = 1e-3
TOL_LOSS_BF16 = 3.2e-2
TOL_BF16_STEM = 1e-2
TOL_BF16 = 5e-2
LR = 1e-3


def jloss(m, x, y):
    return JF.cross_entropy(m(x), y).mean()


def tloss(m, x, y):
    return TF.cross_entropy(m(x), y).mean()


def logits(m, x):
    return m(x)


def np_named(pairs):
    return {n: np.array(t._data) for n, t in pairs}


def state(m):
    """(params, buffers) of a reference model as numpy, by name."""
    return np_named(m.named_parameters()), np_named(m.named_buffers())


def set_state(m, params, buffers):
    for n, p in m.named_parameters():
        p._data = jnp.asarray(params[n])
    for n, b in m.named_buffers():
        b._data = jnp.asarray(buffers[n])


def as_dtype(named, dtype):
    return {n: a.astype(dtype) for n, a in named.items()}


def port(make, params, buffers, **kw):
    """The port's model on the CPU in the dtype of ``params``, loaded with
    the reference's parameters and buffers."""
    m = make(device="cpu", **kw)
    if next(iter(params.values())).dtype == np.float64:
        m = m.double()
    load_named_params(m, params)
    return load_named_buffers(m, buffers)


def batch(b, c, hw, classes, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, c, hw, hw)).astype(dtype),
            r.integers(0, classes, size=(b,)).astype(np.int64))


def momentum_step(model, **kw):
    return TrainStep(model, tloss, Momentum(learning_rate=LR, momentum=0.9),
                     **kw)


def ref_call(m, fn, inputs, grad=False, new_buffers=False):
    """fn(m, *inputs) on the reference, jitted; with ``grad`` also the
    gradient of every parameter, with ``new_buffers`` the buffers the call
    left (by name).  The model's state is left as it was."""
    params = {n: p._data for n, p in m.named_parameters()}
    buffers = {n: b._data for n, b in m.named_buffers()}
    key = jax.random.PRNGKey(0)

    def call(p, *ins):
        return functional_loss_call(m, fn, p, buffers, key, list(ins))
    if new_buffers:
        out, bufs = jax.jit(call)(params, *inputs)
        return np.asarray(out), {n: np.asarray(b) for n, b in bufs.items()}
    if not grad:
        return np.asarray(jax.jit(call)(params, *inputs)[0])
    loss, g = jax.jit(jax.value_and_grad(lambda p, *ins: call(p, *ins)[0]))(
        params, *inputs)
    return float(loss), {n: np.asarray(a) for n, a in g.items()}


def scaled_err(got, want):
    """max |got - want| / (|want| + rms(want))."""
    scale = np.abs(want) + np.sqrt(np.mean(np.square(want)))
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))


def check_grads(model, ref_grads):
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref_grads)
    for n, p in model.named_parameters():
        err = scaled_err(p.grad.numpy(), ref_grads[n])
        assert err <= TOL_GRAD, f"{n}: gradient error {err:.3g}"


def rel_close(got, want, what):
    """max |got - want| <= r * (max |want| + 0.1), r = 1e-4 in f32 and
    RTOL_F64 in f64."""
    r = RTOL_F64 if want.dtype == np.float64 else TOL["rtol"]
    err = float(np.max(np.abs(got - want)))
    lim = r * (float(np.max(np.abs(want))) + 0.1)
    assert err <= lim, f"{what}: {err:.3g} > {lim:.3g}"


def check_params(model, want):
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        rel_close(got[n], want[n], n)


def check_buffers(model, want, bf16=False):
    """Every running stat, in the reference's dtype (f32 under O2)."""
    got = {n: b.numpy() for n, b in model.named_buffers()}
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        if bf16:
            err = scaled_err(got[n], want[n])
            tol = TOL_BF16_STEM if n.startswith("bn1.") else TOL_BF16
            assert err <= tol, f"{n}: bf16 error {err:.3g} > {tol}"
        else:
            rel_close(got[n], want[n], n)
