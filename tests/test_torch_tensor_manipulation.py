"""The port's tensor/manipulation.py against the reference on the CPU
(torch_tensor_common's tolerances: values, output dtypes, and the
gradients of ``sum(out * w)`` through the reference's ``backward()``).

Each gather and scatter gets an index past its axis and a negative one,
so the three JAX behaviours are held: ``gather_nd`` clamps,
``take_along_axis`` / ``index_select`` fill, and every ``.at[...]``
update (``put_along_axis``, ``scatter``, ``scatter_nd_add``,
``scatter_nd``, ``index_add``) drops.  The overwriting scatters get
duplicate indices: the last update wins on the CPU, and the port keeps
the last everywhere (its gradient reaches the winning update only)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch.tensor as T
from paddle_tpu.tensor import manipulation as JM

from torch_tensor_common import BF16, assert_same, check, rng, run

R = rng(20)
X = R.standard_normal((3, 4, 5)).astype(np.float32)
X1 = R.standard_normal((3, 1, 5, 1)).astype(np.float32)
XE = R.standard_normal((1, 4, 1)).astype(np.float32)
X2 = R.standard_normal((4, 6)).astype(np.float32)
ROW = R.standard_normal(5).astype(np.float32)
X4 = R.standard_normal((2, 3, 4, 5)).astype(np.float32)
CPLX = (R.standard_normal((3, 4)) + 1j * R.standard_normal((3, 4))).astype(
    np.complex64)


def _x(dtype):
    return BF16(X) if dtype == "bfloat16" else X.copy()


# (name, args, kwargs, gradient positions); every case runs in f32
CASES = [
    ("reshape", [X, [4, -1]], {}, (0,)),
    ("flatten", [X], {"start_axis": 1, "stop_axis": -1}, ()),
    ("transpose", [X, [2, 0, 1]], {}, ()),
    ("moveaxis", [X, 0, 2], {}, ()),
    ("swapaxes", [X, 0, 2], {}, ()),
    ("t", [X], {}, ()),
    ("unstack", [X], {"axis": 2, "num": 3}, ()),
    ("unbind", [X], {"axis": 0}, ()),
    ("split", [X, [1, -1, 2]], {"axis": 1}, (0,)),
    ("chunk", [X, 2], {"axis": 1}, ()),
    ("squeeze", [X1], {"axis": [1, 2]}, ()),
    ("squeeze_", [X1], {}, ()),
    ("unsqueeze", [X, [0, -1]], {}, ()),
    ("unsqueeze_", [X, 1], {}, ()),
    ("tile", [X, [2]], {}, ()),
    ("expand", [XE, [2, 3, -1, 5]], {}, ()),
    ("expand_as", [XE, X.transpose(2, 1, 0)], {}, ()),
    ("broadcast_to", [XE, [3, 4, 5]], {}, ()),
    ("flip", [X, [0, 2]], {}, ()),
    ("rot90", [X], {"k": 3, "axes": (1, 2)}, ()),
    ("roll", [X, [1, -2]], {"axis": [0, 2]}, ()),
    ("slice", [X, [0, 2], [-2, 1], [100, -1]], {}, ()),
    ("strided_slice", [X, [0, 2], [2, -1], [-5, 0], [-1, -2]], {}, (0,)),
    ("crop", [X, [2, -1, 3], [1, 1, 0]], {}, ()),
    ("pad", [X4, [1, 1, 2, 0]], {"mode": "reflect"}, (0,)),
    ("as_complex", [X2.reshape(4, 3, 2)], {}, ()),
    ("as_real", [CPLX], {}, ()),
    ("real", [CPLX], {}, ()),
    ("imag", [CPLX], {}, ()),
    ("tensordot", [X, X.transpose(1, 2, 0)], {"axes": 2}, (0, 1)),
    ("tensordot", [(X2 * 3).astype(np.int32), X2.T.copy()],
     {"axes": ([1], [0])}, ()),
]


@pytest.mark.parametrize("name,args,kwargs,grad", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_layout(name, args, kwargs, grad):
    check(name, args, kwargs, grad=grad)


@pytest.mark.parametrize("name,extra", [("reshape", [[-1, 5]]),
                                        ("slice", [[1], [1], [3]])])
def test_layout_bf16(name, extra):
    check(name, [BF16(X)] + extra)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_concat_stack_promote(dtype):
    other = X.astype(np.float64) if dtype == "float32" else X.copy()
    check("concat", [[_x(dtype), other]], {"axis": 1})
    check("stack", [[_x(dtype), other]], {"axis": -1})


def test_concat_tensor_axis():
    got = T.concat([torch.from_numpy(X)] * 2, axis=torch.tensor(2))
    assert torch.equal(got, torch.cat([torch.from_numpy(X)] * 2, 2))


def test_concat_stack_gradients():
    xs = [torch.from_numpy(X.copy()).requires_grad_() for _ in range(2)]
    js = [paddle.to_tensor(X.copy()) for _ in range(2)]
    for j in js:
        j.stop_gradient = False
    w = rng(5).standard_normal((3, 8, 5)).astype(np.float32)
    (T.concat(xs, axis=1) * torch.from_numpy(w)).sum().backward()
    (J.concat(js, axis=1) * paddle.to_tensor(w)).sum().backward()
    for t, j in zip(xs, js):
        assert_same(t.grad, j.grad)
    ys = [torch.from_numpy(X.copy()).requires_grad_() for _ in range(2)]
    T.stack(ys, axis=0).pow(2).sum().backward()
    assert torch.equal(ys[1].grad, 2 * ys[1].detach())


def test_broadcast_tensors():
    got, want = run("broadcast_tensors", [[XE, ROW]])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same(g, w)


def test_reshape_in_place():
    x, j = torch.from_numpy(X.copy()), paddle.to_tensor(X.copy())
    assert T.reshape_(x, [5, -1]) is x
    J.reshape_(j, [5, -1])
    assert_same(x, j)


# -- the three out-of-range behaviours ---------------------------------------

IDX_ND = np.array([[0, 1], [7, -1], [-7, 2], [2, 9]], np.int64)
IDX_ALONG = np.array([[[7], [-1], [0], [-6]]], np.int64)       # (1, 4, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_nd_clamps(dtype):
    got, want = check("gather_nd", [_x(dtype), IDX_ND],
                      grad=(0,) if dtype == "float32" else ())
    assert torch.isfinite(got[0]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_take_along_axis_fills(dtype):
    x = (X * 4).astype(np.int32) if dtype == "int32" else _x(dtype)
    got, want = check("take_along_axis", [x, IDX_ALONG], {"axis": 1},
                      grad=(0,) if dtype == "float32" else ())


def test_take_along_axis_broadcasts():
    idx = np.array([[[1, 4, 0]], [[0, 0, 2]], [[3, 3, 3]]], np.int64)
    check("take_along_axis", [X, idx], {"axis": 2})


def test_index_select_fills():
    idx = np.array([3, -1, 9, 0, -9], np.int64)
    check("index_select", [X, idx], {"axis": 1}, grad=(0,),
          ref_fn=JM.index_select, port_fn=T.manipulation.index_select)
    assert T.search.index_select(torch.from_numpy(X), torch.from_numpy(
        idx), axis=1).isnan().sum() == 2 * 3 * 5


PUT_IDX = np.array([[[1], [7], [1], [-1]], [[0], [0], [-9], [2]],
                    [[4], [4], [4], [3]]], np.int64)          # (3, 4, 1)


@pytest.mark.parametrize("reduce,dtype", [
    ("assign", "float32"), ("add", "float32"), ("mul", "float32"),
    ("multiply", "bfloat16")])
def test_put_along_axis_drops(reduce, dtype):
    vals = rng(7).standard_normal((3, 4, 1)).astype(np.float32)
    vals = BF16(vals) if dtype == "bfloat16" else vals
    grad = (0, 2) if dtype == "float32" and reduce in ("assign",
                                                       "add") else ()
    check("put_along_axis", [_x(dtype), PUT_IDX, vals],
          {"axis": 2, "reduce": reduce}, grad=grad)


def test_put_along_axis_scalar_value():
    check("put_along_axis", [X, PUT_IDX, 2.5], {"axis": 2}, grad=(0,))


SCATTER_IDX = np.array([2, 0, 2, 7, -1, -5, 0], np.int64)


@pytest.mark.parametrize("overwrite,dtype", [(True, "float32"),
                                             (False, "float32"),
                                             (True, "bfloat16")])
def test_scatter_drops_and_keeps_the_last(overwrite, dtype):
    upd = rng(8).standard_normal((7, 4, 5)).astype(np.float32)
    upd = BF16(upd) if dtype == "bfloat16" else upd
    check("scatter", [_x(dtype), SCATTER_IDX, upd],
          {"overwrite": overwrite},
          grad=(0, 2) if dtype == "float32" else ())


def test_scatter_last_duplicate_wins():
    """a.at[[1, 1, 1]].set([10, 20, 30]) is 30; the first would be 10."""
    got, want = run("scatter", [np.zeros(3, np.float32),
                                np.array([1, 1, 1]),
                                np.array([10.0, 20.0, 30.0], np.float32)])
    assert np.asarray(want._data).tolist() == [0.0, 30.0, 0.0]
    assert_same(got, want)


ND_IDX = np.array([[[0, 1], [2, 3]], [[0, 1], [7, 0]], [[-1, -1], [1, -9]]],
                  np.int64)                                   # (3, 2, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_nd_add_drops(dtype):
    upd = rng(9).standard_normal((3, 2, 5)).astype(np.float32)
    upd = BF16(upd) if dtype == "bfloat16" else upd
    check("scatter_nd_add", [_x(dtype), ND_IDX, upd],
          grad=(0, 2) if dtype == "float32" else ())


def test_scatter_nd():
    upd = rng(10).standard_normal((3, 2)).astype(np.float32)
    check("scatter_nd", [ND_IDX[..., :1].reshape(3, 2, 1), upd, [6]],
          grad=(1,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_add_drops(dtype):
    val = rng(11).standard_normal((3, 6, 5)).astype(np.float32)
    val = BF16(val) if dtype == "bfloat16" else val
    idx = np.array([0, 3, 0, 4, -1, -6], np.int64)
    check("index_add", [_x(dtype), idx, 1, val],
          grad=(0, 3) if dtype == "float32" else ())


# -- dtypes, host-sized results, indices --------------------------------------

SPECIAL = np.array([np.nan, 1e20, -1e20, 3.7, -3.7, 0.0, 2.5e9, 300.0],
                   np.float32)


@pytest.mark.parametrize("dtype", ["bool", "int32", "uint8", "bfloat16",
                                   "float16"])
def test_cast(dtype):
    check("cast", [SPECIAL.copy(), dtype])


@pytest.mark.parametrize("kw", [
    {}, {"return_index": True, "return_inverse": True, "return_counts": True}])
def test_unique(kw):
    x = np.array([[3, 1, 3], [2, 1, 5]], np.int64)
    check("unique", [x], kw)


@pytest.mark.parametrize("x", [
    np.array([3, np.nan, 1, np.nan], np.float32),
    np.array([[np.nan, 2.0], [np.nan, np.nan]], np.float32),
    np.array([np.nan, 1.0], np.float64)])
def test_unique_keeps_one_nan(x):
    """Every NaN is one value, as jnp.unique's equal_nan keeps it: f32
    [3, nan, 1, nan] gives [1, 3, nan], index [2, 0, 1], inverse
    [1, 2, 0, 2] and counts [1, 1, 2]."""
    got, _ = check("unique", [x], {"return_index": True,
                                   "return_inverse": True,
                                   "return_counts": True})
    if x.shape == (4,):
        np.testing.assert_array_equal(got[1].numpy(), [2, 0, 1])
        np.testing.assert_array_equal(got[2].numpy(), [1, 2, 0, 2])
        np.testing.assert_array_equal(got[3].numpy(), [1, 1, 2])


def test_unique_axis():
    x = np.array([[1, 2], [0, 5], [1, 2], [0, 5], [0, 1]], np.int32)
    check("unique", [x], {"axis": 0, "return_index": True,
                          "return_inverse": True, "return_counts": True})


@pytest.mark.parametrize("axis", [None, 1])
def test_unique_consecutive(axis):
    x = np.array([[1, 1, 2], [1, 1, 2], [3, 3, 3], [1, 1, 2]], np.int64)
    check("unique_consecutive", [x], {"axis": axis, "return_inverse": True,
                                      "return_counts": True})


@pytest.mark.parametrize("repeats,axis", [(2, None)])
def test_repeat_interleave(repeats, axis):
    check("repeat_interleave", [X, repeats], {"axis": axis})


def test_repeat_interleave_tensor_repeats():
    r = np.array([2, 0, 1], np.int64)
    check("repeat_interleave", [X, r], {"axis": 0}, grad=(0,))


@pytest.mark.parametrize("name,args", [
    ("tril_indices", (4, 5, 1)), ("triu_indices", (3, None, -1))])
def test_tri_indices(name, args):
    want = getattr(J, name)(*args)
    got = getattr(T, name)(*args, device="cpu")
    assert_same(got, want)


def test_one_hot_is_nn_functional():
    from paddle_tpu_torch.nn.functional import common
    assert T.one_hot is common.one_hot and T.pad is common.pad
    ids = np.array([[0, 4, -1], [5, 2, 1]], np.int64)
    got, want = run("one_hot", [ids, 5])
    # the port gives float32 where jax.nn.one_hot gives float64
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


@pytest.mark.parametrize("ignore", [99])
def test_shard_index(ignore):
    ids = np.array([[0], [7], [13], [19], [5]], np.int64)
    check("shard_index", [ids, 20, 3, 1], {"ignore_value": ignore})
