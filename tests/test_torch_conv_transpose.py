"""The port's transposed convolutions (``conv{1,2,3}d_transpose`` and
``Conv{1,2,3}DTranspose``) against the reference on the CPU, from the same
numpy inputs: the output and the gradients of sum(out * w) with respect to
the input, the weight and the bias, for a fixed random w.

Every padding form the reference takes (an int, one per dim, a flat list
of 2n, (low, high) pairs, ``"SAME"`` and ``"VALID"`` at stride 1),
``output_padding``, dilation, groups and channel-last.  Tolerance: f32
values and gradients 1e-5 absolute and relative (the two packages sum in
different orders)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.models import load_named_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _run(jfn, tfn, arrays, seed=7):
    """Both functions on the same numpy inputs: (port output, gradients)
    held to the reference's."""
    js = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    oj, ot = jfn(*js), tfn(*ts)
    want = np.asarray(oj._data)
    np.testing.assert_allclose(ot.detach().numpy(), want, **TOL,
                               err_msg="output")
    w = _rng(seed).standard_normal(want.shape).astype(np.float32)
    (oj * paddle.to_tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    for i, (j, t) in enumerate(zip(js, ts)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad._data),
                                   **TOL, err_msg=f"gradient of input {i}")
    return ot


_FN = {1: ("conv1d_transpose", "NLC"), 2: ("conv2d_transpose", "NHWC"),
       3: ("conv3d_transpose", "NDHWC")}

CASES = [
    # (n, cin, cout, k, stride, padding, output_padding, dilation, groups,
    #  channel_last, bias)
    (2, 4, 6, 3, 1, 0, 0, 1, 1, False, True),
    (2, 4, 6, 4, 2, 1, 0, 1, 1, False, True),        # DCGAN's layer
    (2, 4, 6, 3, 2, 1, 1, 1, 1, False, True),        # output_padding
    (2, 4, 6, 3, 3, [1, 2], [2, 0], 1, 1, False, False),
    (2, 4, 6, 3, 2, [0, 2, 1, 0], 0, 1, 1, False, True),   # flat, uneven
    (2, 4, 6, 3, 2, [(2, 0), (1, 3)], 1, 1, 1, False, True),  # pairs
    (2, 4, 6, 3, 2, 3, 0, 1, 1, False, True),        # pad > k_eff - 1
    (2, 4, 6, 3, 2, 0, 1, 2, 1, False, True),        # dilation, out pad
    (2, 4, 6, 3, 1, "SAME", 0, 1, 1, False, True),
    (2, 4, 6, 4, 1, "SAME", 0, 2, 1, False, True),   # even k_eff
    (2, 4, 6, 3, 1, "VALID", 0, 1, 1, False, True),
    (2, 4, 6, 3, 2, 1, 0, 1, 2, False, True),        # groups
    (2, 6, 9, 3, 2, 1, 1, 1, 3, True, True),         # groups, NHWC
    (2, 4, 6, 3, 2, 1, 0, 1, 1, True, False),        # NHWC
    (1, 4, 6, 3, 2, 1, 1, 1, 1, False, True),
    (1, 4, 6, 5, 3, [2, 1], 0, 1, 2, True, True),    # NLC, groups
    (3, 2, 4, 3, 2, 1, 0, 1, 1, False, True),
    (3, 2, 4, 2, [1, 2, 2], [0, 1, 0], [0, 1, 1], 1, 2, True, True),
]


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_conv_transpose_matches_reference(case):
    n, cin, cout, k, stride, pad, opad, dil, groups, last, bias = case
    name, fmt = _FN[n]
    r = _rng(len(str(case)))
    spatial = (5, 6, 4)[:n]
    shape = (2,) + (spatial + (cin,) if last else (cin,) + spatial)
    arrays = [r.standard_normal(shape).astype(np.float32),
              r.standard_normal((cin, cout // groups) + (k,) * n).astype(
                  np.float32)]
    if bias:
        arrays.append(r.standard_normal(cout).astype(np.float32))
    kw = dict(stride=stride, padding=pad, output_padding=opad,
              dilation=dil, groups=groups,
              data_format=fmt if last else fmt[0] + fmt[-1] + fmt[1:-1])

    def call(mod):
        return lambda x, w, *b: getattr(mod, name)(
            x, w, b[0] if b else None, **kw)
    _run(call(JF), call(TF), arrays)


def test_string_padding_at_stride_two_raises_in_both():
    x = np.zeros((1, 2, 4, 4), np.float32)
    w = np.zeros((2, 3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="String padding"):
        JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                            stride=2, padding="SAME")
    with pytest.raises(ValueError, match="String padding"):
        TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            stride=2, padding="SAME")


def test_output_size_taken_only_where_the_reference_computes_it():
    """The reference reads no ``output_size``: its output is 9 x 9 here
    whatever is asked.  The port takes 9 x 9 and refuses 10 x 10."""
    r = _rng(3)
    x = r.standard_normal((1, 2, 4, 4)).astype(np.float32)
    w = r.standard_normal((2, 3, 3, 3)).astype(np.float32)
    ref = JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                              stride=2, padding=0, output_size=[10, 10])
    assert tuple(ref.shape) == (1, 3, 9, 9)
    out = TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                              stride=2, output_size=[9, 9])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._data), **TOL)
    with pytest.raises(NotImplementedError, match="output_size"):
        TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            stride=2, output_size=[10, 10])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_transpose_layers_match_reference(n):
    """``Conv{n}DTranspose`` with the reference's weights, loaded by name:
    shapes, output and every gradient; the port's layer lands on the CPU
    when asked."""
    jcls = getattr(jnn, f"Conv{n}DTranspose")
    tcls = getattr(tnn, f"Conv{n}DTranspose")
    paddle.seed(n)
    jl = jcls(4, 6, 3, stride=2, padding=1, output_padding=1, groups=2)
    tl = tcls(4, 6, 3, stride=2, padding=1, output_padding=1, groups=2,
              device="cpu")
    named = {k: np.asarray(p._data) for k, p in jl.named_parameters()}
    assert {k: v.shape for k, v in named.items()} == {
        k: tuple(p.shape) for k, p in tl.named_parameters()}
    assert named["weight"].shape == (4, 3) + (3,) * n
    load_named_params(tl, named)
    x = _rng(n).standard_normal((2, 4) + (5, 4, 3)[:n]).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    oj, ot = jl(jx), tl(tx)
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj._data),
                               **TOL)
    oj.sum().backward()
    ot.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               **TOL)
    for k, p in jl.named_parameters():
        np.testing.assert_allclose(dict(tl.named_parameters())[k].grad,
                                   np.asarray(p.grad._data), **TOL,
                                   err_msg=k)
