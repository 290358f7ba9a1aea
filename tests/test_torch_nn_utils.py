"""``nn.utils`` of the port against the reference on the CPU: weight_norm
and remove_weight_norm, spectral_norm, parameters_to_vector and
vector_to_parameters.  Both wrap layers of the same weights (carried by
name, ``load_named_params``) and are compared at f32 1e-5 (values) and
1e-4 (gradients).  The reference's quirks have their cases:
``weight_norm(dim=None)`` norms over every axis but 0, as ``dim=0``;
``remove_weight_norm`` folds back over every axis but 0 whatever ``dim``
was; the hook runs once at wrapping; ``spectral_norm(dim=None)`` is dim 0
and its vectors take no gradient and never move, so the eager optimizers
skip them."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.models import load_named_params

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-4)


def _named(layer):
    return {n: np.array(p._data) for n, p in layer.named_parameters()}


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _layers(kind):
    """A reference layer and the port's with the reference's weights."""
    if kind == "linear":
        ref, port = jnn.Linear(5, 4), tnn.Linear(5, 4, device="cpu")
        shape = (3, 5)
    else:
        ref, port = (jnn.Conv2D(3, 4, 3, padding=1),
                     tnn.Conv2D(3, 4, 3, padding=1, device="cpu"))
        shape = (2, 3, 5, 5)
    load_named_params(port, _named(ref))
    return ref, port, shape


def _forward_backward(ref, port, shape, seed=1):
    """Outputs and every gradient (input's, each parameter's) of
    sum(out * w), compared."""
    x = _x(*shape, seed=seed)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    oj, ot = ref(jx), port(tx)
    want = np.asarray(oj._data)
    np.testing.assert_allclose(ot.detach().numpy(), want, **TOL)
    w = _x(*want.shape, seed=seed + 1)
    (oj * paddle.to_tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               **TOL_GRAD)
    got = dict(port.named_parameters())
    for n, p in ref.named_parameters():
        if p.grad is None:
            assert got[n].grad is None, n
            continue
        np.testing.assert_allclose(got[n].grad.numpy(),
                                   np.asarray(p.grad._data), err_msg=n,
                                   **TOL_GRAD)


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm(kind, dim):
    ref, port, shape = _layers(kind)
    jnn.utils.weight_norm(ref, dim=dim)
    tnn.utils.weight_norm(port, dim=dim)
    names = [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in port.named_parameters()] == names == [
        "bias", "weight_g", "weight_v"]
    for n, want in _named(ref).items():
        np.testing.assert_allclose(
            dict(port.named_parameters())[n].detach().numpy(), want,
            err_msg=n, **TOL)
    # the hook ran once at wrapping: the weight is there before a call
    np.testing.assert_allclose(port.weight.detach().numpy(),
                               np.asarray(ref.weight._data), **TOL)
    _forward_backward(ref, port, shape)


def test_weight_norm_dim_none_norms_all_but_axis_0():
    """dim=None takes the same g as dim=0 in both packages."""
    ref, port, _ = _layers("conv")
    jnn.utils.weight_norm(ref, dim=None)
    tnn.utils.weight_norm(port, dim=None)
    assert tuple(port.weight_g.shape) == tuple(ref.weight_g.shape) == (
        4, 1, 1, 1)


@pytest.mark.parametrize("dim", [0, 1])
def test_remove_weight_norm_folds_over_axes_after_0(dim):
    """After a training step on g and v, remove_weight_norm folds them
    back with the norm over every axis but 0, whatever ``dim`` was: at
    dim=1 that weight is not the one the forward used."""
    ref, port, shape = _layers("linear")
    jnn.utils.weight_norm(ref, dim=dim)
    tnn.utils.weight_norm(port, dim=dim)
    _forward_backward(ref, port, shape)
    jo = jopt.SGD(learning_rate=0.5, parameters=ref.parameters())
    to = topt.SGD(learning_rate=0.5, parameters=port.parameters())
    jo.step()
    to.step()
    jnn.utils.remove_weight_norm(ref)
    tnn.utils.remove_weight_norm(port)
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()] == ["bias", "weight"]
    np.testing.assert_allclose(port.weight.detach().numpy(),
                               np.asarray(ref.weight._data), **TOL)
    x = _x(*shape, seed=4)
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        np.asarray(ref(paddle.to_tensor(x))._data), **TOL)
    assert not port._layer_pre_hooks


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("dim,iters", [(None, 1), (1, 2)])
def test_spectral_norm(kind, dim, iters):
    ref, port, shape = _layers(kind)
    jnn.utils.spectral_norm(ref, n_power_iterations=iters, dim=dim)
    tnn.utils.spectral_norm(port, n_power_iterations=iters, dim=dim)
    names = [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in port.named_parameters()] == names == [
        "bias", "weight_orig", "weight_spectral_norm.weight_u",
        "weight_spectral_norm.weight_v"]
    load_named_params(port, _named(ref))
    _forward_backward(ref, port, shape)


def test_spectral_norm_vectors_never_move():
    """Two eager Adam steps: the weight and bias move as the reference's,
    weight_u and weight_v take no gradient and stay."""
    ref, port, shape = _layers("conv")
    jnn.utils.spectral_norm(ref)
    tnn.utils.spectral_norm(port)
    load_named_params(port, _named(ref))
    before = _named(ref)
    jo = jopt.Adam(learning_rate=0.01, parameters=ref.parameters())
    to = topt.Adam(learning_rate=0.01, parameters=port.parameters())
    for step in range(2):
        x = _x(*shape, seed=10 + step)
        (ref(paddle.to_tensor(x)) ** 2).mean().backward()
        (port(torch.from_numpy(x)) ** 2).mean().backward()
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    for n, want in _named(ref).items():
        np.testing.assert_allclose(got[n], want, err_msg=n, **TOL)
    for n in ("weight_spectral_norm.weight_u",
              "weight_spectral_norm.weight_v"):
        np.testing.assert_array_equal(got[n], before[n])
    assert not np.allclose(got["weight_orig"], before["weight_orig"])


def test_parameters_vector_round_trip():
    ref, port, _ = _layers("conv")
    jv = jnn.utils.parameters_to_vector(ref.parameters())
    tv = tnn.utils.parameters_to_vector(port.parameters())
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv._data))
    assert tv.requires_grad and tuple(tv.shape) == (4 * 3 * 9 + 4,)
    new = np.arange(tv.numel(), dtype=np.float32)
    jnn.utils.vector_to_parameters(paddle.to_tensor(new), ref.parameters())
    tnn.utils.vector_to_parameters(torch.from_numpy(new), port.parameters())
    for n, want in _named(ref).items():
        np.testing.assert_array_equal(
            dict(port.named_parameters())[n].detach().numpy(), want)
