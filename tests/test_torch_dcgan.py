"""A small DCGAN (``torch_dcgan_common``: ngf = ndf = 8, B = 4, 64 x 64)
in the port against the same model in the reference on the CPU, the
weights carried by name: D's and G's losses in f32, then one iteration
of the eager loop in f64 held step by step: D's loss, every gradient of
D, D's parameters after its ``Adam(2e-4, beta1=0.5)`` step, G's loss on
the same images, every gradient of G and G's parameters after its step.

Why f64 for the gradients and the steps: the networks are ReLU and
LeakyReLU stacks, whose f32 gradients flip at kinks between two
implementations (``torch_vision_common``'s docstring), and Adam's first
move is lr * sign(g), which a gradient within rounding of 0 flips.  Both
packages keep BatchNorm's statistics in f32 (the reference's rule), so
the f64 gradients differ by about 1e-7, and Adam's first move turns that
into up to 1e-3 of a move where a gradient is near its epsilon: each
step therefore runs on the reference's gradients, once they are held.
Tolerances: f32 losses 1e-5 relative;
f64 losses, gradients (max |got - want| / (|want| + rms(want))) and the
steps' moves (max |got - want| / (max |want| + lr)) 1e-5."""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.models import load_named_buffers, load_named_params
from torch_dcgan_common import Z_DIM, d_loss, discriminator, g_loss, \
    generator

NGF = NDF = 8
B = 4
LR = 2e-4
TOL = 1e-5


def _models(dtype):
    """(reference G, D), (port G, D) in one state, in ``dtype``."""
    paddle.seed(0)
    ref = generator(jnn, NGF), discriminator(jnn, NDF)
    port = []
    for jm, tm in zip(ref, (generator(tnn, NGF, device="cpu"),
                            discriminator(tnn, NDF, device="cpu"))):
        params = {n: np.asarray(p._data).astype(dtype)
                  for n, p in jm.named_parameters()}
        buffers = {n: np.asarray(b._data).astype(dtype)
                   for n, b in jm.named_buffers()}
        for n, p in jm.named_parameters():
            p._data = jnp.asarray(params[n])
        for n, b in jm.named_buffers():
            b._data = jnp.asarray(buffers[n])
        if dtype == np.float64:
            tm = tm.double()
        load_named_params(tm, params)
        port.append(load_named_buffers(tm, buffers))
    return ref, tuple(port)


def _batch(dtype):
    r = np.random.default_rng(1)
    real = r.uniform(-1, 1, (B, 3, 64, 64)).astype(dtype)
    z = r.standard_normal((B, Z_DIM, 1, 1)).astype(dtype)
    ones = np.ones((B, 1, 1, 1), dtype)
    return real, z, ones, np.zeros_like(ones)


def _scaled(got, want):
    scale = np.abs(want) + np.sqrt(np.mean(np.square(want)))
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))


def _check_grads(jm, tm, what):
    """Every gradient held to the reference's, then replaced by it: the
    step that follows moves both packages from the same gradients."""
    named = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        want = np.asarray(p.grad._data)
        err = _scaled(named[n].grad.numpy(), want)
        assert err <= TOL, f"{what} gradient {n}: {err:.3g}"
        named[n].grad = torch.from_numpy(want.copy())


def _check_moves(jm, tm, before, what):
    named = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        want = np.asarray(p._data) - before[n]
        got = named[n].detach().numpy() - before[n]
        assert np.abs(want).max() > 0, f"{what} {n} did not move"
        err = float(np.abs(got - want).max() / (np.abs(want).max() + LR))
        assert err <= TOL, f"{what} move of {n}: {err:.3g}"


def test_shapes_and_initialisation():
    """G maps (B, 100, 1, 1) to (B, 3, 64, 64) in [-1, 1], D to one logit a
    sample; the port's convolution weights are N(0, 0.02)."""
    (jg, jd), (tg, td) = _models(np.float32)
    z = torch.from_numpy(_batch(np.float32)[1])
    img = tg(z)
    assert tuple(img.shape) == (B, 3, 64, 64) and img.abs().max() <= 1
    assert tuple(td(img).shape) == (B, 1, 1, 1)
    fresh = generator(tnn, 128, device="cpu")
    w = fresh[0].weight.detach()
    assert tuple(w.shape) == (100, 1024, 4, 4)
    assert abs(float(w.mean())) < 1e-3 and abs(float(w.std()) - 0.02) < 1e-3
    assert fresh[0].bias is None and fresh[-2].bias is not None


def test_f32_losses_match_reference():
    (jg, jd), (tg, td) = _models(np.float32)
    real, z, ones, zeros = _batch(np.float32)
    jl, tl = jnn.BCEWithLogitsLoss(), tnn.BCEWithLogitsLoss()
    fj = jg(paddle.to_tensor(z))
    ft = tg(torch.from_numpy(z))
    want = [float(d_loss(jl, jd, paddle.to_tensor(real), fj,
                         paddle.to_tensor(ones), paddle.to_tensor(zeros))),
            float(g_loss(jl, jd, fj, paddle.to_tensor(ones)))]
    got = [float(d_loss(tl, td, torch.from_numpy(real), ft,
                        torch.from_numpy(ones), torch.from_numpy(zeros))),
           float(g_loss(tl, td, ft, torch.from_numpy(ones)))]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_f64_iteration_matches_reference():
    (jg, jd), (tg, td) = _models(np.float64)
    real, z, ones, zeros = (np.asarray(a) for a in _batch(np.float64))
    jl, tl = jnn.BCEWithLogitsLoss(), tnn.BCEWithLogitsLoss()
    jopt_d = jopt.Adam(learning_rate=LR, beta1=0.5,
                       parameters=jd.parameters())
    jopt_g = jopt.Adam(learning_rate=LR, beta1=0.5,
                       parameters=jg.parameters())
    topt_d = topt.Adam(learning_rate=LR, beta1=0.5,
                       parameters=td.parameters())
    topt_g = topt.Adam(learning_rate=LR, beta1=0.5,
                       parameters=tg.parameters())
    J = {k: paddle.to_tensor(v) for k, v in
         dict(real=real, z=z, ones=ones, zeros=zeros).items()}
    T = {k: torch.from_numpy(v) for k, v in
         dict(real=real, z=z, ones=ones, zeros=zeros).items()}
    fj, ft = jg(J["z"]), tg(T["z"])
    # D step
    lj = d_loss(jl, jd, J["real"], fj, J["ones"], J["zeros"])
    lt = d_loss(tl, td, T["real"], ft, T["ones"], T["zeros"])
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    lj.backward()
    lt.backward()
    _check_grads(jd, td, "D")
    before = {n: np.asarray(p._data) for n, p in jd.named_parameters()}
    jopt_d.step()
    topt_d.step()
    _check_moves(jd, td, before, "D")
    jopt_d.clear_grad()
    topt_d.clear_grad()
    # G step on the same images
    lj = g_loss(jl, jd, fj, J["ones"])
    lt = g_loss(tl, td, ft, T["ones"])
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    lj.backward()
    lt.backward()
    _check_grads(jg, tg, "G")
    before = {n: np.asarray(p._data) for n, p in jg.named_parameters()}
    jopt_g.step()
    topt_g.step()
    _check_moves(jg, tg, before, "G")
    for o in (jopt_g, jopt_d, topt_g, topt_d):
        o.clear_grad()
