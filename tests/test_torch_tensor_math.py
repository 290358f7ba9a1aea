"""The port's tensor/math.py against the reference on the CPU, every
function × dtype on seeded numpy inputs (4 x 8 values): values and
output dtypes, and gradients of float32 calls (torch_tensor_common's
tolerances).  Trouble spots get their own cases, each beside the naive
PyTorch call it must not be: x64 promotion (int32 + 1.5 is float64),
``hypot`` overflowing at 1e20, ``digamma(0)`` NaN, tied gradients of
``max`` and ``maximum`` / ``clip``, the last tied index of ``cummax``,
``logsumexp`` over a row of -inf, ``prod`` with one and two zeros,
``accuracy`` on tied rows."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch.tensor as T

from torch_tensor_common import BF16, assert_same, check, rng, run

SHAPE = (4, 8)

DOMAIN = {
    "exp": "any", "expm1": "any", "log": "pos", "log2": "pos",
    "log10": "pos", "log1p": "pos", "sqrt": "pos", "rsqrt": "pos",
    "square": "any", "abs": "any", "sign": "any", "ceil": "any",
    "floor": "any", "round": "any", "trunc": "any", "frac": "any",
    "sin": "any", "cos": "any", "tan": "unit", "asin": "unit",
    "acos": "unit", "atan": "any", "sinh": "any", "cosh": "any",
    "tanh": "any", "asinh": "any", "acosh": "ge1", "atanh": "unit",
    "erf": "any", "erfinv": "unit", "reciprocal": "pos", "neg": "any",
    "digamma": "pos", "lgamma": "pos", "sigmoid": "any", "conj": "any",
    "angle": "any", "deg2rad": "any", "rad2deg": "any",
}
# lax functions the reference refuses an integer tensor for
NO_INT = {"rsqrt", "erf", "erfinv", "sigmoid", "sign_bool"}


def _values(domain, dtype, seed=0):
    r = rng(seed)
    if dtype == "int32":
        lo, hi = {"any": (-3, 4), "pos": (1, 6), "unit": (-1, 2),
                  "ge1": (1, 6)}[domain]
        return r.integers(lo, hi, SHAPE).astype(np.int32)
    x = r.standard_normal(SHAPE).astype(np.float32)
    x = {"any": x, "pos": np.abs(x) + 0.1, "unit": np.tanh(x) * 0.9,
         "ge1": np.abs(x) + 1.1}[domain]
    return BF16(x) if dtype == "bfloat16" else x


# the integer rule is one per family: a function of floats takes int32 to
# float32 (int64 to float64), the others keep the dtype; bf16 is held on
# a few of each kind
INT_CASES = ["exp", "deg2rad", "sign", "angle", "reciprocal"]
BF16_CASES = ["exp", "rsqrt"]
# gradients where a formula or an edge could differ: the functions with
# a pole, a kink or a domain edge, and the port's own backward formulas
GRAD = {"sqrt", "rsqrt", "log1p", "expm1", "tan", "asin", "acos", "atanh",
        "acosh", "asinh", "erfinv", "digamma", "lgamma", "sigmoid", "abs",
        "frac", "reciprocal", "angle", "log2", "cosh"}
UNARY_CASES = ([(n, "float32") for n in DOMAIN]
               + [(n, "int32") for n in INT_CASES]
               + [(n, "bfloat16") for n in BF16_CASES])


@pytest.mark.parametrize("name,dtype", UNARY_CASES)
def test_unary(name, dtype):
    x = _values(DOMAIN[name], dtype)
    grad = (0,) if dtype == "float32" and name in GRAD else ()
    check(name, [x], grad=grad)


def _pair(kind, seed=1):
    r = rng(seed)
    a = r.standard_normal(SHAPE).astype(np.float32)
    b = r.standard_normal(SHAPE).astype(np.float32)
    b[0, :3] = a[0, :3]                       # ties: a == b
    if kind == "f32":
        return a, b
    if kind == "int32":
        ia = r.integers(-6, 7, SHAPE).astype(np.int32)
        ib = r.integers(1, 4, SHAPE).astype(np.int32)
        return ia, ib
    if kind == "int32_pyfloat":
        return r.integers(-6, 7, SHAPE).astype(np.int32), 1.5
    if kind == "f32_pyint":
        return a, 2
    if kind == "bf16_pyfloat":
        return BF16(a), 0.1
    if kind == "f32_f64_0d":
        return a, np.asarray(0.3, np.float64)
    raise ValueError(kind)


BINARY = ["add", "subtract", "multiply", "divide", "floor_divide",
          "remainder", "mod", "floor_mod", "pow", "maximum", "minimum",
          "fmax", "fmin", "atan2", "hypot", "logaddexp", "divide_no_nan"]
# float32 pairs (with ties) for every function and its gradients; the
# promotions on the functions where they differ from PyTorch's
PROMOTIONS = [
    ("divide", "int32"), ("floor_divide", "int32"), ("remainder", "int32"),
    ("divide_no_nan", "int32"), ("add", "int32_pyfloat"),
    ("pow", "int32_pyfloat"), ("hypot", "int32_pyfloat"),
    ("pow", "f32_pyint"), ("add", "bf16_pyfloat"), ("hypot", "f32_f64_0d"),
    ("maximum", "f32_f64_0d")]
NO_GRAD = {"floor_divide"}


@pytest.mark.parametrize("name,kind", [(n, "f32") for n in BINARY]
                         + PROMOTIONS)
def test_binary(name, kind):
    a, b = _pair(kind)
    if name == "pow" and kind in ("f32", "f32_f64_0d"):
        a = np.abs(a) + 0.5
    if name in ("floor_divide", "remainder", "mod", "floor_mod") and \
            kind == "f32":
        b = np.where(np.abs(b) < 0.1, 0.7, b).astype(np.float32)
    grad = (0, 1) if kind == "f32" and name not in NO_GRAD else ()
    check(name, [a, b], grad=grad)


def test_int32_plus_python_float_is_float64_not_torchs_float32():
    x = np.array([1, 2, 3], np.int32)
    got, want = run("add", [x, 1.5])
    assert str(want.dtype) == "float64" and got.dtype == torch.float64
    assert (torch.from_numpy(x) + 1.5).dtype == torch.float32   # naive
    got, want = run("reciprocal", [x])
    assert got.dtype == torch.float64 and str(want.dtype) == "float64"
    got, want = run("divide", [x, x])
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"


def test_hypot_overflows_at_1e20_as_the_reference():
    a = np.array([1e20, 3.0], np.float32)
    got, want = run("hypot", [a, a])
    assert np.isinf(np.asarray(want._data)[0])
    assert_same(got, want)
    naive = torch.hypot(torch.from_numpy(a), torch.from_numpy(a))
    assert np.isfinite(naive.numpy()[0])


def test_digamma_at_zero_is_nan_not_minus_inf():
    x = np.array([0.0, -1.0, 0.5, 2.0], np.float32)
    got, want = run("digamma", [x])
    assert np.isnan(np.asarray(want._data)[0])
    assert_same(got, want)
    assert torch.digamma(torch.from_numpy(x))[0] == -float("inf")  # naive
    at0 = np.array([0.0, 0.5, 3.0], np.float32)
    check("lgamma", [at0], grad=(0,))       # the gradient at 0 is NaN
    t = torch.from_numpy(at0).requires_grad_()
    torch.lgamma(t).sum().backward()
    assert t.grad[0] == -float("inf")                            # naive


@pytest.mark.parametrize("name,axis", [("max", None), ("max", 1),
                                       ("min", 1), ("amax", [0, 1]),
                                       ("amin", 1)])
def test_extreme_reductions_split_tied_gradients(name, axis):
    x = rng(2).standard_normal(SHAPE).astype(np.float32)
    x[1, 2] = x[1, 5] = x.max() + 1.0          # a tie at the maximum
    x[2, 1] = x[2, 6] = x.min() - 1.0          # and at the minimum
    check(name, [x], {"axis": axis}, grad=(0,))


def test_max_tie_differs_from_torch_max_with_dim():
    x = np.array([[1.0, 3.0, 3.0]], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    torch.max(t, dim=1).values.sum().backward()
    want = paddle.to_tensor(x, stop_gradient=False)
    J.max(want, axis=1).sum().backward()
    assert not np.array_equal(t.grad.numpy(), np.asarray(want.grad._data))
    check("max", [x], {"axis": 1}, grad=(0,))


@pytest.mark.parametrize("name", ["maximum", "minimum"])
def test_maximum_halves_a_tied_gradient(name):
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([1.0, 5.0, 3.0], np.float32)
    got, _ = check(name, [a, b], grad=(0, 1))


def test_clip_halves_the_gradient_at_a_bound():
    x = np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32)
    check("clip", [x], {"min": -1.0, "max": 1.0}, grad=(0,))
    t = torch.from_numpy(x).requires_grad_()
    torch.clamp(t, -1.0, 1.0).sum().backward()       # naive: 1 at a bound
    assert t.grad[1] == 1.0
    ref = paddle.to_tensor(x, stop_gradient=False)
    J.clip(ref, -1.0, 1.0).sum().backward()
    assert np.asarray(ref.grad._data)[1] == 0.5


def test_clip_of_int_with_float_bounds_is_float64():
    x = np.array([-3, 0, 4], np.int32)
    check("clip", [x], {"min": -1.5, "max": 2.5})


REDUCTIONS = ["sum", "prod", "mean", "nanmean", "nansum", "logsumexp",
              "all", "any", "count_nonzero"]


DIFFERENTIABLE = {"sum", "prod", "mean", "nanmean", "nansum", "logsumexp"}
REDUCTION_CASES = (
    [(n, 1, True, "float32") for n in REDUCTIONS]
    + [(n, [0, 1], True, "float32") for n in ("prod", "any",
                                              "count_nonzero")]
    + [(n, None, False, "int32") for n in ("sum", "prod", "mean",
                                           "logsumexp")]
    + [(n, -1, False, "bool") for n in ("sum", "all")])


@pytest.mark.parametrize("name,axis,keepdim,dtype", REDUCTION_CASES)
def test_reduction(name, axis, keepdim, dtype):
    """Gradients at one axis form of each; values and dtypes at the
    others."""
    r = rng(3)
    if dtype == "float32":
        x = (r.standard_normal(SHAPE) * 0.5 + 1).astype(np.float32)
        if name.startswith("nan"):
            x[1, 3] = np.nan
    elif dtype == "int32":
        x = r.integers(-3, 4, SHAPE).astype(np.int32)
    else:
        x = r.integers(0, 2, SHAPE).astype(bool)
    grad = (0,) if dtype == "float32" and name in DIFFERENTIABLE and \
        axis == 1 else ()
    check(name, [x], {"axis": axis, "keepdim": keepdim}, grad=grad)


@pytest.mark.parametrize("zeros", [1, 2])
def test_prod_with_zeros(zeros):
    x = np.array([[2.0, 3.0, 0.0, 4.0], [1.5, 0.0, 2.0, 0.0]], np.float32)
    if zeros == 1:
        x[1, 3] = 5.0
    check("prod", [x], {"axis": 1}, grad=(0,))
    check("prod", [x], grad=(0,))


def test_logsumexp_of_a_row_of_minus_inf():
    x = np.array([[-np.inf] * 4, [0.0, 1.0, -np.inf, 2.0]], np.float32)
    got, want = check("logsumexp", [x], {"axis": 1}, grad=(0,))
    assert np.isneginf(np.asarray(want[0]._data)[0])


@pytest.mark.parametrize("name,axis,dtype", [
    ("cumsum", None, "float32"), ("cumprod", 1, "float32"),
    ("cumsum", 1, "int32"), ("cumprod", 1, "to_f64")])
def test_cumulative(name, axis, dtype):
    r = rng(4)
    x = (r.standard_normal(SHAPE) * 0.5 + 1).astype(np.float32)
    kw = {"axis" if name == "cumsum" else "dim": axis}
    if dtype == "int32":
        x = r.integers(-2, 3, SHAPE).astype(np.int32)
    elif dtype == "bool":
        x = r.integers(0, 2, SHAPE).astype(bool)
    elif dtype == "to_f64":
        kw["dtype"] = "float64"
    got, _ = check(name, [x], kw, grad=(0,) if dtype == "float32" else ())
    if dtype == "int32":        # jnp keeps int32; torch.cumsum gives int64
        assert got[0].dtype == torch.int32
        assert getattr(torch, name)(torch.from_numpy(x), 1).dtype == \
            torch.int64


@pytest.mark.parametrize("name,axis", [("cummax", None), ("cummin", 1)])
def test_cummax_cummin_index_the_last_tie(name, axis):
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                  [5.0, 1.0, 1.0, 0.5, 0.5, 9.0]], np.float32)
    check(name, [x], {"axis": axis})
    y = rng(5).standard_normal(SHAPE).astype(np.float32)   # no ties
    check(name, [y], {"axis": axis}, grad=(0,))


@pytest.mark.parametrize("case", ["int", "act", "tensor"])
def test_scale(case):
    x = rng(6).standard_normal(SHAPE).astype(np.float32)
    kw = {"scale": 2.5, "bias": 0.5}
    if case == "int":
        x = rng(6).integers(-5, 6, SHAPE).astype(np.int32)
    elif case == "before":
        kw["bias_after_scale"] = False
    elif case == "act":
        kw["act"] = "relu"
    if case == "tensor":
        check("scale", [x, np.asarray(1.5, np.float32)], {"bias": 0.25},
              grad=(0,))
    else:
        check("scale", [x], kw, grad=(0,) if case != "int" else ())


@pytest.mark.parametrize("name", ["lerp", "stanh", "kron", "inner", "outer",
                                  "cross", "cross_axis0", "dot", "addmm",
                                  "multiplex"])
def test_composite(name):
    r = rng(7)
    a = r.standard_normal(SHAPE).astype(np.float32)
    b = r.standard_normal(SHAPE).astype(np.float32)
    if name == "lerp":
        check("lerp", [a, b, np.float32(0.3) * np.ones(SHAPE, np.float32)],
              grad=(0, 1, 2))
    elif name == "stanh":
        check("stanh", [a], grad=(0,))
    elif name in ("kron", "inner", "outer"):
        check(name, [a[:2, :3], b[:3, :3]],
              grad=(0, 1) if name == "kron" else ())
    elif name == "cross":
        check("cross", [a[:, :3], b[:, :3]], grad=(0, 1))
    elif name == "cross_axis0":
        check("cross", [a[:3], b[:3]], {"axis": 0})
    elif name == "dot":
        check("dot", [a, b], grad=(0, 1))
        check("dot", [a[0], b[0]])
    elif name == "addmm":
        check("addmm", [a[:, :3], a, b.T[:, :3].copy()],
              {"beta": 0.5, "alpha": 2.0}, grad=(0, 1, 2))
    else:
        idx = np.array([[1], [0], [2], [1]], np.int32)
        c = r.standard_normal(SHAPE).astype(np.float32)
        got = T.multiplex([torch.from_numpy(v) for v in (a, b, c)],
                          torch.from_numpy(idx))
        want = J.multiplex([paddle.to_tensor(v) for v in (a, b, c)],
                           paddle.to_tensor(idx))
        assert_same(got, want)


@pytest.mark.parametrize("name", ["isfinite", "isinf", "isnan"])
def test_float_classes(name):
    x = np.array([0.0, np.inf, -np.inf, np.nan, 1.5], np.float32)
    check(name, [x])


@pytest.mark.parametrize("name,equal_nan", [("isclose", False),
                                            ("isclose", True),
                                            ("allclose", False),
                                            ("equal_all", None)])
def test_closeness(name, equal_nan):
    a = np.array([1.0, 2.0, np.nan, np.inf, 1e-9], np.float32)
    b = np.array([1.0 + 1e-6, 2.1, np.nan, np.inf, 0.0], np.float32)
    kw = {} if equal_nan is None else {"equal_nan": equal_nan}
    check(name, [a, b], kw)
    check(name, [a, a], kw)


@pytest.mark.parametrize("case", ["n2", "append_axis0", "bool"])
def test_diff(case):
    x = rng(8).standard_normal(SHAPE).astype(np.float32)
    kw = {"n2": {"n": 2}, "prepend": {"prepend": 0.5},
          "append_axis0": {"append": np.ones((1, 8), np.float32),
                           "axis": 0}}.get(case, {})
    if case == "bool":
        x = x > 0
    check("diff", [x], kw, grad=(0,) if case in ("n1", "n2", "prepend")
          else ())


@pytest.mark.parametrize("offset,dtype", [(1, "float32"), (-2, "int32")])
def test_trace(offset, dtype):
    x = rng(9).standard_normal((5, 5)).astype(np.float32)
    if dtype == "int32":
        x = (x * 3).astype(np.int32)
    check("trace", [x], {"offset": offset},
          grad=(0,) if dtype == "float32" else ())


def test_increment_is_in_place_outside_the_tape():
    t = torch.tensor([1.0, 2.0], requires_grad=True)
    with torch.no_grad():
        x = t * 1.0
    out = T.increment(x, 2.0)
    assert out is x and x.tolist() == [3.0, 4.0]
    j = J.increment(paddle.to_tensor(np.array([1.0, 2.0], np.float32)), 2.0)
    assert_same(out, j)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_accuracy_on_tied_rows(k):
    """Rows with tied scores: lax.top_k keeps the lower index, so the
    label at the higher tied index misses at k=1."""
    x = np.array([[0.5, 0.9, 0.9, 0.1], [0.3, 0.3, 0.3, 0.3],
                  [0.2, 0.1, 0.7, 0.7]], np.float32)
    label = np.array([[2], [1], [3]], np.int64)
    got, want = run("accuracy", [x, label], {"k": k})
    assert_same(got, want)
    naive = (torch.topk(torch.from_numpy(x), k).indices
             == torch.from_numpy(label)).any(1).float().mean()
    assert (float(naive) != float(got)) == (k > 1)     # torch.topk's ties
