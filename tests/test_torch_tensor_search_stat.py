"""The port's tensor/search.py, tensor/manipulation.py's gathers and
tensor/stat.py against the reference on the CPU (torch_tensor_common's
tolerances; every index output bitwise).  Rows carry planted ties, so
each order the reference defines is held: ``argsort`` / ``sort``
descending (the last tied index first, where ``torch.argsort(
descending=True, stable=True)`` puts the first first), ``topk`` (the
lower index first), ``kthvalue`` and ``mode`` (the smallest of the most
frequent values, at its last position); ``median`` averages the two
middle values (``torch.median`` takes the lower); ``quantile`` and
``nanquantile`` interpolate as jnp does, on slices holding NaN too."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch.tensor as T

from torch_tensor_common import assert_same, check, rng, run

TIED = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5],
                 [2.0, 2.0, 1.0, 1.0, 7.0, 7.0],
                 [4.0, 4.0, 4.0, 4.0, 4.0, 4.0]], np.float32)


def _tied(dtype="float32"):
    return TIED.astype(np.int32) if dtype == "int32" else TIED.copy()


@pytest.mark.parametrize("name,axis,keepdim,dtype", [
    ("argmax", None, False, "float32"), ("argmax", 0, True, "bool"),
    ("argmin", 1, True, "float32"), ("argmin", None, False, "int32")])
def test_argmax_argmin_first_tie(name, axis, keepdim, dtype):
    x = _tied("int32" if dtype == "int32" else "float32")
    if dtype == "bool":
        x = x > 2
    check(name, [x], {"axis": axis, "keepdim": keepdim})


@pytest.mark.parametrize("name,axis,descending", [
    ("argsort", -1, True), ("argsort", 0, True), ("argsort", -1, False),
    ("sort", -1, True), ("sort", 0, False)])
def test_sorts_on_tied_rows(name, axis, descending):
    check(name, [_tied()], {"axis": axis, "descending": descending},
          grad=(0,) if name == "sort" and descending else ())


def test_descending_argsort_is_not_torchs_stable_descending():
    row = np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32)
    got, want = run("argsort", [row], {"descending": True})
    assert np.asarray(want._data).tolist() == [[4, 2, 1, 3, 0]]
    assert_same(got, want)
    naive = torch.argsort(torch.from_numpy(row), descending=True,
                          stable=True)
    assert naive.tolist() == [[1, 2, 4, 3, 0]]


@pytest.mark.parametrize("largest,k,axis", [(True, 3, None), (False, 2, -1),
                                           (True, 2, 0), (False, 1, None)])
def test_topk_lower_index_first_among_ties(largest, k, axis):
    got, want = check("topk", [_tied()], {"k": k, "axis": axis,
                                          "largest": largest},
                      grad=(0,) if k == 3 else ())
    naive = torch.topk(torch.from_numpy(_tied()), k, dim=-1 if axis is None
                       else axis, largest=largest).indices
    if axis is None:               # the tied rows: torch.topk's order differs
        assert not torch.equal(naive, got[1])


def test_topk_tensor_k_and_int_rows():
    check("topk", [_tied("int32")], {"k": 2})
    got = T.topk(torch.from_numpy(_tied()), torch.tensor(2))
    want = J.topk(paddle.to_tensor(_tied()), paddle.to_tensor(np.int64(2)))
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("right,out_int32,kind", [
    (False, False, "float"), (True, True, "float"),
    (True, False, "int_seq_float_values")])
def test_searchsorted(right, out_int32, kind):
    seq = np.array([0.0, 1.0, 1.0, 2.5, 4.0, 4.0, 9.0], np.float32)
    vals = np.array([[1.0, 4.0, -1.0], [9.0, 3.0, 1.5]], np.float32)
    if kind == "int_seq_float_values":
        seq = seq.astype(np.int32)
    check("searchsorted", [seq, vals], {"right": right,
                                         "out_int32": out_int32})


@pytest.mark.parametrize("case", ["tensors", "int_pyfloat", "scalars"])
def test_where(case):
    r = rng(1)
    cond = r.integers(0, 2, (3, 4)).astype(bool)
    a = r.standard_normal((3, 4)).astype(np.float32)
    b = r.standard_normal((3, 4)).astype(np.float32)
    if case == "tensors":
        check("where", [cond, a, b], grad=(1, 2))
    elif case == "int_pyfloat":
        check("where", [cond, a.astype(np.int32), 1.5])
    else:
        check("where", [cond, 2, 0.5])


def test_where_alone_is_nonzero():
    cond = rng(2).integers(0, 2, (3, 4)).astype(bool)
    check("where", [cond])


@pytest.mark.parametrize("as_tuple", [False, True])
def test_nonzero(as_tuple):
    x = rng(3).integers(-1, 2, (3, 4)).astype(np.float32)
    check("nonzero", [x], {"as_tuple": as_tuple})


def test_masked_select_broadcasts_the_mask():
    x = rng(4).standard_normal((3, 4)).astype(np.float32)
    check("masked_select", [x, np.array([True, False, True, True])])


@pytest.mark.parametrize("name,axis,kind", [
    ("index_select", 0, "in_range"), ("index_select", 1, "negative"),
    ("gather", 1, "out_of_range"), ("gather", 0, "negative")])
def test_gather_and_index_select(axis, kind, name):
    """An index outside [-n, n) reads the fill value (NaN, or the
    smallest integer), as jnp.take reads it."""
    x = rng(5).standard_normal((4, 5)).astype(np.float32)
    idx = {"in_range": [0, 3, 3, 1], "negative": [-1, 2, -4, 0],
           "out_of_range": [0, 7, -9, 2]}[kind]
    idx = np.array(idx, np.int64)
    ref_fn = J.manipulation.gather if name == "gather" else None
    port_fn = T.manipulation.gather if name == "gather" else None
    check(name, [x, idx], {"axis": axis},
          grad=(0,) if kind == "in_range" else (), ref_fn=ref_fn,
          port_fn=port_fn)
    check(name, [x.astype(np.int32), idx], {"axis": axis}, ref_fn=ref_fn,
          port_fn=port_fn)


@pytest.mark.parametrize("kind", ["in_range", "negative", "out_of_range"])
def test_index_sample(kind):
    x = rng(6).standard_normal((3, 5)).astype(np.float32)
    idx = {"in_range": [[0, 4, 4], [1, 1, 2], [3, 0, 2]],
           "negative": [[-1, 0, 2], [-5, 1, 1], [0, 0, -2]],
           "out_of_range": [[5, 0, 1], [-6, 2, 2], [1, 9, 0]]}[kind]
    check("index_sample", [x, np.array(idx, np.int64)],
          grad=(0,) if kind == "in_range" else ())


@pytest.mark.parametrize("k,axis,keepdim", [(3, -1, True), (2, 0, False)])
def test_kthvalue_indexes_the_stable_sort(k, axis, keepdim):
    got, _ = check("kthvalue", [_tied()], {"k": k, "axis": axis,
                                            "keepdim": keepdim},
                   grad=(0,) if keepdim else ())
    naive = torch.kthvalue(torch.from_numpy(_tied()), k, dim=axis,
                           keepdim=keepdim).indices
    if axis == -1:                 # along the tied rows
        assert not torch.equal(naive, got[1])


@pytest.mark.parametrize("axis,keepdim,dtype", [(-1, False, "float32"),
                                                (0, True, "int32"),
                                                (1, True, "float32")])
def test_mode_smallest_most_frequent_at_its_last_position(axis, keepdim,
                                                          dtype):
    x = np.array([[1, 2, 2, 1, 3, 3], [5, 4, 4, 5, 5, 4],
                  [0, 9, 8, 7, 6, 5], [2, 2, 2, 1, 1, 1]], np.float32)
    if dtype == "int32":
        x = x.astype(np.int32)
    check("mode", [x], {"axis": axis, "keepdim": keepdim})


def test_mode_on_random_rows_with_repeats():
    x = rng(7).integers(0, 4, (16, 9)).astype(np.int64)
    check("mode", [x])


STATS = ["mean", "std", "var"]


@pytest.mark.parametrize("name,axis,keepdim,unbiased", [
    ("mean", [0, 1], True, False), ("std", 1, True, True),
    ("var", [0, 1], True, False)])
def test_moments(name, axis, keepdim, unbiased):
    x = rng(8).standard_normal((4, 6)).astype(np.float32)
    kw = {"axis": axis, "keepdim": keepdim}
    if name != "mean":
        kw["unbiased"] = unbiased
    elif not unbiased:
        x = x.astype(np.int32)          # mean of int32 is float32
    check(name, [x], kw, grad=(0,) if x.dtype == np.float32 else ())


@pytest.mark.parametrize("name,axis,keepdim", [
    ("median", None, False), ("median", 1, True), ("nanmedian", 0, False)])
def test_median_averages_the_middle_pair(name, axis, keepdim):
    x = rng(9).standard_normal((4, 6)).astype(np.float32)
    x[2, 1] = x[2, 4]                           # a tie
    if name == "nanmedian":
        x[1, 2] = x[3, 0] = np.nan
    check(name, [x], {"axis": axis, "keepdim": keepdim},
          grad=(0,) if axis in (None, 0) else ())


def test_median_is_not_torch_median():
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    got, want = run("median", [x])
    assert float(np.asarray(want._data)) == 2.5
    assert_same(got, want)
    assert float(torch.median(torch.from_numpy(x))) == 2.0     # naive


def test_median_of_a_slice_holding_nan_is_nan():
    x = np.array([[1.0, np.nan, 3.0], [4.0, 5.0, 6.0]], np.float32)
    check("median", [x], {"axis": 1})
    check("median", [x])


@pytest.mark.parametrize("name,q,axis,keepdim", [
    ("quantile", 0.5, None, False), ("quantile", [0.1, 0.5, 0.99], 1, False),
    ("nanquantile", [0.1, 0.5, 0.99], None, False),
    ("nanquantile", 0.9, [0, 1], True)])
def test_quantile(name, q, axis, keepdim):
    x = rng(10).standard_normal((4, 7)).astype(np.float32)
    if name == "nanquantile":
        x[0, 3] = x[2, 2] = np.nan
    check(name, [x], {"q": q, "axis": axis, "keepdim": keepdim},
          grad=(0,) if axis is None else ())


def test_quantile_of_int_and_all_nan_rows():
    check("quantile", [np.arange(12, dtype=np.int32).reshape(3, 4)],
          {"q": 0.3, "axis": 1})
    x = np.array([[np.nan] * 3, [1.0, np.nan, 2.0]], np.float32)
    check("nanquantile", [x], {"q": [0.25, 0.75], "axis": 1})


def test_quantile_interpolates_between_the_sorted_values():
    x = rng(11).standard_normal(1000).astype(np.float32)
    got = T.quantile(torch.from_numpy(x), [0.5, 0.9, 0.99])
    s = np.sort(x)
    for q, v in zip((0.5, 0.9, 0.99), got.numpy()):
        i = int(np.floor(q * 999))
        assert s[i] <= v <= s[min(i + 1, 999)]


def test_numel_resolves_to_creation():
    assert T.numel is T.creation.numel and T.stat.numel is T.numel
    check("numel", [np.zeros((3, 4), np.float32)])
