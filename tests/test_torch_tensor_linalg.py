"""The port's tensor/linalg.py against the reference on the CPU.

Products, norms and distances run in float32 at torch_tensor_common's
tolerances.  The decompositions and solvers run in float64 (the two
libraries' LAPACK calls differ in their last bits, which float32 would
magnify by the condition number): values and gradients within
``TOL_F64`` (1e-9, on matrices of condition number below 100).
Where a decomposition is not unique (signs and order of singular and
eigen vectors, ``eig``'s order), the test holds its invariants:
reconstruction, orthogonality, the singular / eigen values.  ``lu``'s 0-based
int32 pivots are held bitwise, beside ``torch.linalg.lu_factor``'s
1-based ones.  ``qr(mode="r")`` returns R, as the reference means to:
its ``tuple()`` of jnp's R hands back R's first row, which the port
does not copy."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch.tensor as T

from torch_tensor_common import assert_same, check, port_np, ref_np, rng, run

TOL_F64 = dict(rtol=1e-9, atol=1e-9)


def _mat(n=4, m=None, seed=0, dtype=np.float64):
    r = rng(seed)
    a = r.standard_normal((n, m or n))
    if m is None:
        a = a + n * np.eye(n)                     # well conditioned
    return a.astype(dtype)


def _spd(n=4, seed=1):
    a = rng(seed).standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(np.float64)


@pytest.mark.parametrize("case", ["tx", "ty", "int_f32", "bmm", "mv"])
def test_matmul_family(case):
    r = rng(2)
    a = r.standard_normal((3, 4)).astype(np.float32)
    b = r.standard_normal((4, 2)).astype(np.float32)
    if case == "tx":
        check("matmul", [a.T.copy(), b], {"transpose_x": True}, grad=(0, 1))
    elif case == "ty":
        check("matmul", [a, b.T.copy()], {"transpose_y": True})
    elif case == "batched":
        check("matmul", [np.stack([a, a * 2]), b])
    elif case == "int_f32":
        check("matmul", [(a * 3).astype(np.int32), b])
    elif case == "mm":
        check("mm", [a, b])
    elif case == "bmm":
        check("bmm", [np.stack([a, a]), np.stack([b, -b])])
    else:
        check("mv", [a, b[:, 1].copy()])


INF = float("inf")


@pytest.mark.parametrize("p,axis,keepdim,grad", [
    ("fro", None, False, True), (2, None, True, False),
    (0, None, False, False), (INF, -1, True, True), (-INF, 1, False, False),
    (3, 1, False, True)])
def test_vector_norms(p, axis, keepdim, grad):
    x = rng(3).standard_normal((3, 5)).astype(np.float32)
    check("norm", [x], {"p": p, "axis": axis, "keepdim": keepdim},
          grad=(0,) if grad else ())


@pytest.mark.parametrize("p,keepdim,grad", [
    ("nuc", True, True), (-1, True, False), (2, False, True),
    (INF, False, False)])
def test_matrix_norms(p, keepdim, grad):
    x = rng(4).standard_normal((2, 3, 4)).astype(np.float64)
    check("norm", [x], {"p": p, "axis": [1, 2], "keepdim": keepdim},
          grad=(0,) if grad else (), tol=TOL_F64)


def test_fro_norm_of_zeros_has_a_nan_gradient():
    got, _ = check("norm", [np.zeros((2, 3), np.float32)], grad=(0,))
    z = torch.zeros(2, 3, requires_grad=True)
    torch.linalg.norm(z).backward()
    assert not torch.isnan(z.grad).any()                 # naive: 0
    check("norm", [rng(5).standard_normal(4).astype(np.float32)],
          {"p": 2, "axis": [0]}, grad=(0,))


@pytest.mark.parametrize("p", [2, 0, 3, INF, -INF])
def test_dist(p):
    r = rng(6)
    a = r.standard_normal((3, 4)).astype(np.float32)
    b = r.standard_normal((3, 4)).astype(np.float32)
    check("dist", [a, b], {"p": p}, grad=(0, 1) if p in (2, 3) else ())


@pytest.mark.parametrize("p", [None, 1, -2])
def test_cond(p):
    check("cond", [_mat(4, seed=7)], {"p": p},
          grad=(0,) if p is None else (), tol=TOL_F64)


@pytest.mark.parametrize("upper", [False, True])
def test_cholesky_and_solve(upper):
    a = _spd()
    grad = () if upper else (0,)
    check("cholesky", [a], {"upper": upper}, grad=grad, tol=TOL_F64)
    fac = np.linalg.cholesky(a)
    fac = fac.T.copy() if upper else fac
    b = rng(8).standard_normal((4, 2))
    check("cholesky_solve", [b, fac], {"upper": upper},
          grad=() if upper else (0, 1), tol=TOL_F64)


def test_cholesky_of_an_indefinite_matrix_is_nan():
    a = np.diag([1.0, -2.0, 3.0])
    got, want = run("cholesky", [a])
    assert np.isnan(ref_np(want)).any()
    assert np.isnan(port_np(got)).any()


@pytest.mark.parametrize("name", ["inverse", "det", "slogdet"])
def test_inverse_det_slogdet(name):
    a = _mat(4, seed=9)
    check(name, [np.stack([a, -a.T])], grad=(0,) if name != "det" else (),
          tol=TOL_F64)


def test_slogdet_stacks_sign_and_logdet():
    got, want = run("slogdet", [-_mat(3, seed=10)])
    assert tuple(got.shape) == (2,) and ref_np(want).shape == (2,)


@pytest.mark.parametrize("shape,full", [((5, 3), False), ((3, 5), False),
                                        ((4, 4), True)])
def test_svd_invariants(shape, full):
    x = _mat(*shape, seed=11)
    got, want = run("svd", [x], {"full_matrices": full})
    u, s, vh = (port_np(t) for t in got)
    np.testing.assert_allclose(s, ref_np(want[1]), **TOL_F64)
    k = s.shape[0]
    np.testing.assert_allclose((u[:, :k] * s) @ vh[:k], x, **TOL_F64)
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), **TOL_F64)
    assert u.shape == ref_np(want[0]).shape
    assert vh.shape == ref_np(want[2]).shape


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_invariants(mode):
    x = _mat(5, 3, seed=12)
    got, want = run("qr", [x], {"mode": mode})
    r_got = port_np(got if mode == "r" else got[1])
    r_want = ref_np(J.qr(paddle.to_tensor(x))[1] if mode == "r"
                    else want[1])
    np.testing.assert_allclose(np.abs(r_got), np.abs(r_want), **TOL_F64)
    if mode != "r":
        q = port_np(got[0])
        np.testing.assert_allclose(q @ r_got, x if mode == "reduced" else x,
                                   **TOL_F64)
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), **TOL_F64)


def test_eig_and_eigvals_as_sets():
    a = _mat(4, seed=13)
    (w, v), want = run("eig", [a])
    key = lambda z: np.sort_complex(np.round(z, 9))     # noqa: E731
    np.testing.assert_allclose(key(port_np(w)), key(ref_np(want[0])),
                               **TOL_F64)
    np.testing.assert_allclose(a @ port_np(v), port_np(v) * port_np(w),
                               **TOL_F64)
    got, want = run("eigvals", [a])
    assert str(got.dtype).endswith("complex128")
    np.testing.assert_allclose(key(port_np(got)), key(ref_np(want)),
                               **TOL_F64)


@pytest.mark.parametrize("uplo", ["U"])
def test_eigh_and_eigvalsh(uplo):
    a = _spd(seed=14)
    got, want = run("eigh", [a], {"UPLO": uplo})
    np.testing.assert_allclose(port_np(got[0]), ref_np(want[0]), **TOL_F64)
    w, v = port_np(got[0]), port_np(got[1])
    np.testing.assert_allclose(a @ v, v * w, **TOL_F64)
    check("eigvalsh", [a], {"UPLO": uplo}, grad=(0,), tol=TOL_F64)


@pytest.mark.parametrize("n", [3, -2])
def test_matrix_power(n):
    check("matrix_power", [_mat(3, seed=15) / 4], {"n": n},
          grad=(0,) if n == 3 else (), tol=TOL_F64)


@pytest.mark.parametrize("case", ["full", "deficient", "tol", "vector"])
def test_matrix_rank(case):
    x = _mat(4, 5, seed=16)
    kw = {}
    if case == "deficient":
        x[3] = x[0] + x[1]
    elif case == "tol":
        kw["tol"] = 1.5
    elif case == "vector":
        x = x[0]
    check("matrix_rank", [x], kw)


@pytest.mark.parametrize("n", [3, 4])
def test_multi_dot(n):
    r = rng(17)
    mats = [r.standard_normal(s) for s in [(2, 5), (5, 3), (3, 4),
                                           (4, 2)][:n]]
    got = T.multi_dot([torch.from_numpy(m) for m in mats])
    want = J.multi_dot([paddle.to_tensor(m) for m in mats])
    assert_same(got, want, tol=TOL_F64)


@pytest.mark.parametrize("case", ["tall", "deficient"])
def test_pinv(case):
    x = {"square": _mat(4, seed=18), "tall": _mat(5, 3, seed=18),
         "deficient": np.outer(np.arange(1.0, 5.0), np.arange(1.0, 4.0))}[
             case]
    check("pinv", [x], grad=(0,) if case != "deficient" else (),
          tol=TOL_F64)


@pytest.mark.parametrize("case", ["vector", "matrix", "batched",
                                  "f32_int"])
def test_solve(case):
    a = _mat(4, seed=19)
    b = rng(20).standard_normal((4, 3))
    if case == "vector":
        check("solve", [a, b[:, 0].copy()], tol=TOL_F64)
    elif case == "matrix":
        check("solve", [a, b], grad=(0, 1), tol=TOL_F64)
    elif case == "batched":
        check("solve", [np.stack([a, a.T]), np.stack([b, -b])],
              tol=TOL_F64)
    else:
        check("solve", [a.astype(np.float32), (b * 3).astype(np.int32)],
              tol=dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("upper,transpose,unit", [
    (True, False, False), (False, True, False), (True, True, True),
    (False, False, True)])
def test_triangular_solve(upper, transpose, unit):
    a = _mat(4, seed=21)
    a = np.triu(a) if upper else np.tril(a)
    b = rng(22).standard_normal((4, 2))
    check("triangular_solve", [a, b], {"upper": upper,
                                       "transpose": transpose,
                                       "unitriangular": unit},
          grad=(0, 1) if upper and not transpose else (), tol=TOL_F64)


@pytest.mark.parametrize("case", ["tall", "wide", "deficient", "rcond"])
def test_lstsq(case):
    """All four outputs: the solution, the squared residual norms (jnp's:
    never empty), the rank and the singular values."""
    x = {"tall": _mat(6, 3, seed=23), "wide": _mat(3, 5, seed=23),
         "deficient": np.outer(np.arange(1.0, 7.0), [1.0, 2.0, 3.0]),
         "vector": _mat(6, 3, seed=23), "rcond": _mat(6, 3, seed=23)}[case]
    b = rng(24).standard_normal((x.shape[0], 2))
    if case == "vector":
        b = b[:, 0].copy()
    kw = {"rcond": 0.5} if case == "rcond" else {}
    check("lstsq", [x, b], kw, tol=TOL_F64)
    if case == "tall":
        check("lstsq", [x.astype(np.float32), b.astype(np.float32)], kw,
              tol=dict(rtol=2e-5, atol=2e-5))


@pytest.mark.parametrize("get_infos", [False, True])
def test_lu_pivots_are_zero_based_int32(get_infos):
    a = np.array([[1.0, 2.0, 0.5], [3.0, 4.0, 1.0], [0.0, 5.0, 2.0]])
    check("lu", [a], {"get_infos": get_infos}, tol=TOL_F64)
    naive = torch.linalg.lu_factor(torch.from_numpy(a)).pivots
    want = ref_np(J.lu(paddle.to_tensor(a))[1])
    assert not np.array_equal(naive.numpy(), want)        # 1-based


@pytest.mark.parametrize("name,rowvar", [("cov", True),
                                         ("corrcoef", False)])
def test_cov_corrcoef(name, rowvar):
    x = rng(25).standard_normal((3, 6)).astype(np.float32)
    check(name, [x], {"rowvar": rowvar}, grad=(0,) if rowvar == (
        name == "cov") else ())


def test_cov_ddof_and_ignored_weights():
    x = rng(26).standard_normal((3, 6)).astype(np.float32)
    check("cov", [x], {"ddof": False}, grad=(0,))
    got = T.cov(torch.from_numpy(x), fweights=torch.arange(6),
                aweights=torch.rand(6))
    want = J.cov(paddle.to_tensor(x))
    assert_same(got, want)
    naive = torch.cov(torch.from_numpy(x), fweights=torch.arange(6))
    assert not torch.allclose(naive, got)
    check("cov", [x[0].copy()])
    check("corrcoef", [x[0].copy()])


@pytest.mark.parametrize("case", ["data_range", "outside", "int",
                                  "constant"])
def test_histogram(case):
    x = rng(27).standard_normal(40).astype(np.float32)
    kw = {"bins": 7}
    if case == "given_range":
        kw.update(min=-1.0, max=1.5)
    elif case == "outside":
        kw.update(min=-0.5, max=0.5)
    elif case == "int":
        x = (x * 4).astype(np.int32)
    elif case == "constant":
        x = np.full(5, 2.0, np.float32)
    check("histogram", [x], kw)


@pytest.mark.parametrize("case", ["plain", "weights", "minlength"])
def test_bincount(case):
    x = rng(28).integers(0, 6, 20).astype(np.int64)
    if case == "weights":
        w = rng(29).standard_normal(20).astype(np.float32)
        got = T.bincount(torch.from_numpy(x), torch.from_numpy(w))
        want = J.bincount(paddle.to_tensor(x), paddle.to_tensor(w))
        assert_same(got, want)
    else:
        check("bincount", [x], {"minlength": 10 if case == "minlength"
                                else 0})


def test_linalg_mode_raises():
    """As the reference's ``linalg.mode`` does (linalg.py:216-220)."""
    with pytest.raises(NotImplementedError):
        T.linalg.mode(torch.ones(3))
