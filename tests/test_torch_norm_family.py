"""The norm family of the port (``instance_norm``, ``group_norm``,
``local_response_norm``, ``normalize`` and the layers ``GroupNorm``,
``InstanceNorm1D/2D/3D``, ``LocalResponseNorm``, ``SpectralNorm``)
against the reference on the CPU from the same numpy inputs: values and
the gradients of sum(out * w), for a fixed random w, with respect to the
input and every weight.

Tolerances: f32 values 1e-5 and gradients 1e-4 (absolute and relative);
bf16 by max |got - want| / (|want| + rms(want)) <= 2e-2, as
``test_torch_vision_functional.py`` (the two packages round the same sums
at different steps).  The reference's quirks have their cases: a bias
without a weight scales the output, LRN's alpha is not divided by
``size``, ``normalize``'s all-zero row has a NaN gradient in both, and
``SpectralNorm`` never updates its vectors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.amp as tamp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.models import load_named_params

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = 2e-2


def _close(got, want, dtype, what, tol=TOL):
    if dtype != "bf16":
        np.testing.assert_allclose(got, want, **tol, err_msg=what)
        return
    scale = np.abs(want) + np.sqrt(np.mean(np.square(want)))
    err = float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))
    assert err <= TOL_BF16, f"{what}: bf16 error {err:.3g} > {TOL_BF16}"


def _x(*shape, seed=0, shift=0.0):
    rng = np.random.default_rng(seed + 7 * len(shape))
    return rng.standard_normal(shape).astype(np.float32) + shift


def _f32(a):
    return np.asarray(a, np.float32)


def _compare(jfn, tfn, inputs, dtype="f32", seed=99):
    """Both on the numpy ``inputs`` (every one differentiated), in
    ``dtype``: the outputs and every input's gradient."""
    js = [paddle.to_tensor(jnp.asarray(a, jnp.bfloat16) if dtype == "bf16"
                           else a, stop_gradient=False) for a in inputs]
    ts = [torch.from_numpy(a.copy()).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)
        .requires_grad_() for a in inputs]
    out_j, out_t = jfn(*js), tfn(*ts)
    assert out_t.dtype == (torch.bfloat16 if dtype == "bf16"
                           else torch.float32)
    want = _f32(out_j._data)
    _close(_f32(out_t.detach().float()), want, dtype, "output")
    w = np.random.default_rng(seed).standard_normal(want.shape).astype(
        np.float32)
    (out_j * paddle.to_tensor(jnp.asarray(w, out_j._data.dtype))).sum() \
        .backward()
    (out_t * torch.from_numpy(w).to(out_t.dtype)).sum().backward()
    for i, (j, t) in enumerate(zip(js, ts)):
        _close(_f32(t.grad.float()), _f32(j.grad._data), dtype,
               f"gradient of input {i}", TOL_GRAD)
    return out_t


def _wb(c, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32))


DTYPES = ["f32", "bf16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 4, 7), (2, 4, 5, 6), (2, 3, 4, 3, 5)])
def test_instance_norm(shape, dtype):
    w, b = _wb(shape[1])
    x = _x(*shape, shift=2.0)
    _compare(lambda a, ww, bb: JF.instance_norm(a, weight=ww, bias=bb,
                                                eps=1e-5),
             lambda a, ww, bb: TF.instance_norm(a, weight=ww, bias=bb,
                                                eps=1e-5),
             [x, w, b], dtype)
    _compare(JF.instance_norm, TF.instance_norm, [x], dtype)


def test_instance_norm_bias_without_weight_scales():
    """The reference hands the tensors present on as (scale, shift): a
    bias alone scales the output; the port does the same."""
    _, b = _wb(4)
    x = _x(2, 4, 5, 6)
    out = _compare(lambda a, bb: JF.instance_norm(a, bias=bb),
                   lambda a, bb: TF.instance_norm(a, bias=bb), [x, b])
    base = TF.instance_norm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               (base * torch.from_numpy(b)[:, None, None])
                               .numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt,shape,groups", [("NCHW", (2, 6, 5, 4), 3),
                                              ("NCHW", (2, 6, 5, 4), 6),
                                              ("NHWC", (2, 5, 4, 6), 2),
                                              ("NCL", (3, 6, 7), 3),
                                              ("NLC", (3, 7, 6), 1),
                                              ("NCDHW", (2, 6, 3, 4, 2), 2)])
def test_group_norm(fmt, shape, groups, dtype):
    c = shape[-1] if fmt in ("NHWC", "NLC") else shape[1]
    w, b = _wb(c)
    x = _x(*shape, shift=-1.5)
    _compare(lambda a, ww, bb: JF.group_norm(a, groups, 1e-5, ww, bb, fmt),
             lambda a, ww, bb: TF.group_norm(a, groups, 1e-5, ww, bb, fmt),
             [x, w, b], dtype)


def test_group_norm_without_affine():
    _compare(lambda a: JF.group_norm(a, 2), lambda a: TF.group_norm(a, 2),
             [_x(2, 6, 5, 4)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt,shape,size", [("NCHW", (2, 7, 4, 5), 5),
                                            ("NCHW", (2, 6, 3, 3), 4),
                                            ("NHWC", (2, 4, 5, 7), 3),
                                            ("NCL", (3, 5, 6), 2)])
def test_local_response_norm(fmt, shape, size, dtype):
    x = _x(*shape) * 3.0
    _compare(lambda a: JF.local_response_norm(a, size, 1e-2, 0.75, 2.0,
                                              fmt),
             lambda a: TF.local_response_norm(a, size, 1e-2, 0.75, 2.0,
                                              fmt), [x], dtype)


def test_local_response_norm_alpha_is_not_divided_by_size():
    """PyTorch's LRN divides alpha by size; the reference's does not, and
    neither does the port's."""
    x = torch.from_numpy(_x(2, 6, 3, 3) * 3.0)
    port = TF.local_response_norm(x, 5, 0.1, 0.75, 1.0)
    torch_lrn = torch.nn.functional.local_response_norm(x, 5, 0.1, 0.75,
                                                        1.0)
    scaled = torch.nn.functional.local_response_norm(x, 5, 0.5, 0.75, 1.0)
    assert not torch.allclose(port, torch_lrn, rtol=1e-3)
    np.testing.assert_allclose(port.numpy(), scaled.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,axis", [(2, 1), (2, -1), (1, 1), (3, 0)])
def test_normalize(p, axis, dtype):
    x = _x(4, 5, 6)
    _compare(lambda a: JF.normalize(a, p, axis),
             lambda a: TF.normalize(a, p, axis), [x], dtype)


def test_normalize_zero_row_gradient_matches():
    """An all-zero row: the output is 0 and the gradient NaN in both
    (0 * d sqrt(s) / ds at s = 0), the other rows finite and equal."""
    x = _x(4, 5)
    x[2] = 0.0
    js = paddle.to_tensor(x, stop_gradient=False)
    ts = torch.from_numpy(x.copy()).requires_grad_()
    oj, ot = JF.normalize(js, axis=1), TF.normalize(ts, axis=1)
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj._data),
                               **TOL)
    oj.sum().backward()
    ot.sum().backward()
    want = np.asarray(js.grad._data)
    assert np.isnan(want[2]).all()
    np.testing.assert_allclose(ts.grad.numpy(), want, **TOL_GRAD)


# -- layers -------------------------------------------------------------------

def _named(layer):
    return {n: np.array(p._data) for n, p in layer.named_parameters()}


LAYERS = [
    ("GroupNorm", (3, 6), {}, (2, 6, 4, 5)),
    ("GroupNorm", (2, 6), dict(data_format="NHWC"), (2, 4, 5, 6)),
    ("GroupNorm", (2, 6), dict(weight_attr=False, bias_attr=False),
     (2, 6, 4)),
    ("InstanceNorm1D", (4,), {}, (3, 4, 9)),
    ("InstanceNorm2D", (4,), dict(epsilon=1e-3), (2, 4, 5, 6)),
    ("InstanceNorm3D", (3,), dict(weight_attr=False), (2, 3, 4, 3, 2)),
    ("LocalResponseNorm", (3,), dict(alpha=1e-2, k=2.0), (2, 6, 4, 4)),
]


@pytest.mark.parametrize("name,args,kw,shape", LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_norm_layers(name, args, kw, shape):
    ref = getattr(jnn, name)(*args, **kw)
    port = getattr(tnn, name)(*args, **kw, **(
        {} if name == "LocalResponseNorm" else dict(device="cpu")))
    named = _named(ref)
    rng = np.random.default_rng(5)
    named = {n: a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
             for n, a in named.items()}
    for n, a in named.items():
        getattr(ref, n).set_value(a)
    load_named_params(port, named)
    x = _x(*shape, shift=1.0)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    oj, ot = ref(jx), port(tx)
    want = np.asarray(oj._data)
    np.testing.assert_allclose(ot.detach().numpy(), want, **TOL)
    w = np.random.default_rng(1).standard_normal(want.shape).astype(
        np.float32)
    (oj * paddle.to_tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               **TOL_GRAD)
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(grads) == set(named)
    for n, p in ref.named_parameters():
        np.testing.assert_allclose(grads[n], np.asarray(p.grad._data),
                                   err_msg=n, **TOL_GRAD)


@pytest.mark.parametrize("dim,iters,shape", [(0, 1, (6, 4)),
                                             (1, 3, (5, 3, 2, 2))])
def test_spectral_norm_layer(dim, iters, shape):
    """The weight over its spectral norm, and the weight's gradient
    through the power iteration; weight_u and weight_v take no gradient
    and do not move."""
    ref = jnn.SpectralNorm(list(shape), dim=dim, power_iters=iters)
    port = load_named_params(
        tnn.SpectralNorm(list(shape), dim=dim, power_iters=iters,
                         device="cpu"), _named(ref))
    assert [n for n, _ in port.named_parameters()] == ["weight_u",
                                                       "weight_v"]
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    x = _x(*shape)
    out = _compare(ref, port, [x])
    out2 = port(torch.from_numpy(x))
    assert torch.equal(out.detach(), out2.detach())
    for n, p in port.named_parameters():
        assert p.grad is None and torch.equal(p, before[n]), n


def test_norm_layers_under_auto_cast():
    """group_norm and instance_norm are black-listed (f32 under O1 and
    O2, whatever comes in), local_response_norm, normalize and
    spectral_norm on neither list (the AMP dtype under O2, as they come
    under O1)."""
    x16 = torch.from_numpy(_x(2, 4, 3, 3)).bfloat16()
    x32 = x16.float()
    sn = tnn.SpectralNorm([4, 2], device="cpu")
    w = torch.from_numpy(_x(4, 2))
    with tamp.auto_cast(level="O1"), tamp.trace_ops() as t1:
        assert TF.group_norm(x16, 2).dtype == torch.float32
        assert TF.instance_norm(x16).dtype == torch.float32
        assert TF.local_response_norm(x16, 3).dtype == torch.bfloat16
        assert TF.normalize(x32).dtype == torch.float32
    with tamp.auto_cast(level="O2"), tamp.trace_ops() as t2:
        assert TF.group_norm(x16, 2).dtype == torch.float32
        assert TF.local_response_norm(x32, 3).dtype == torch.bfloat16
        assert TF.normalize(x32).dtype == torch.bfloat16
        assert sn(w).dtype == torch.bfloat16
    assert [n for n, _ in t1] == ["group_norm", "instance_norm",
                                  "local_response_norm", "normalize"]
    assert t2 == [("group_norm", [torch.float32]),
                  ("local_response_norm", [torch.bfloat16]),
                  ("normalize", [torch.bfloat16]),
                  ("spectral_norm", [torch.bfloat16] * 3)]
