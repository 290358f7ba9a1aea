"""The port's tensor/creation.py and tensor/logic.py against the reference
on the CPU (torch_tensor_common's tolerances): the reference's dtype
rules (a Python float is the default dtype, a numpy array keeps its
dtype, ``full``'s fill decides its dtype, ``arange`` of ints is int64),
``linspace`` / ``logspace`` bitwise the reference's (``torch.linspace``
is up to 6e-8 away), ``empty`` as zeros, ``diag`` with a padding value,
``assign`` in place, and the comparisons / logical / bitwise functions
with the reference's promotion.  Creation defaults to the card: without
one it raises, and ``device="cpu"`` makes a CPU tensor."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch.tensor as T
from paddle_tpu_torch.framework import dtype as tdtype

from torch_tensor_common import BF16, assert_same, check, rng

CPU = {"device": "cpu"}


@pytest.mark.parametrize("data", [1.5, [1.0, 2.5], 3, [1, 2], True,
                                  "f64_array", "i32_array", "tensor_list"])
def test_to_tensor_dtype_rules(data):
    if data == "tensor_list":
        want = J.to_tensor([paddle.to_tensor(np.float32(1.0)),
                            paddle.to_tensor(np.float32(2.0))])
        got = T.to_tensor([torch.tensor(1.0), torch.tensor(2.0)], **CPU)
    else:
        data = {"f64_array": np.array([1.5, 2.5]),
                "i32_array": np.array([1, 2], np.int32)}.get(
                    data if isinstance(data, str) else None, data)
        want, got = J.to_tensor(data), T.to_tensor(data, **CPU)
    assert_same(got, want)


def test_to_tensor_dtype_place_and_gradient():
    got = T.to_tensor([1, 2], dtype="float64", place="cpu",
                      stop_gradient=False)
    assert got.dtype == torch.float64 and got.requires_grad
    src = torch.ones(2, requires_grad=True)
    copy = T.to_tensor(src, **CPU)
    assert not copy.requires_grad and copy.data_ptr() != src.data_ptr()


@pytest.mark.parametrize("name,args,kw", [
    ("zeros", [[2, 3]], {}), ("ones", [[2, 3]], {"dtype": "int32"}),
    ("empty", [[2, 3]], {}), ("full", [[2, 2], 1.5], {}),
    ("full", [[2, 2], 7], {}), ("full", [[2, 2], True], {}),
    ("full", [[2, 2], 2], {"dtype": "float64"}), ("eye", [3], {}),
    ("eye", [2, 4], {"dtype": "int64"}), ("arange", [5], {}),
    ("arange", [1, 7, 2], {}), ("arange", [0.0, 1.0, 0.1], {}),
    ("arange", [0, 2, 0.3], {"dtype": "float64"}),
    ("linspace", [0, 1, 7], {}), ("linspace", [-2.5, 3.1, 13], {}),
    ("linspace", [0, 10, 4], {"dtype": "int64"}),
    ("linspace", [0.1, 0.9, 9], {"dtype": "float64"}),
    ("linspace", [1.0, 1.0, 1], {}),
    ("logspace", [0, 2, 5], {}), ("logspace", [0, 1, 4], {"base": 2.0}),
])
def test_creation_from_python_values(name, args, kw):
    """Bitwise, but for ``logspace`` (the two ``pow``s, torch_tensor_
    common's tolerance) and float64 ``linspace`` (4.4e-16 relative: XLA
    fuses ``i * (stop / div)`` into the sum with an FMA, which the port
    reproduces exactly in float32 through float64 but not in float64)."""
    want = getattr(J, name)(*args, **kw)
    got = getattr(T, name)(*args, **kw, **CPU)
    tol = dict(rtol=0, atol=0)
    if name == "logspace":
        tol = None
    elif name == "linspace" and kw.get("dtype") == "float64":
        tol = dict(rtol=4.4e-16, atol=0)
    assert_same(got, want, name, tol=tol)


def test_linspace_is_bitwise_the_reference_not_torch_linspace():
    want = np.asarray(J.linspace(0, 1, 7)._data)
    got = T.linspace(0, 1, 7, **CPU).numpy()
    np.testing.assert_array_equal(got, want)
    naive = torch.linspace(0, 1, 7).numpy()
    assert np.abs(naive - want).max() > 0      # 5.96e-8 at index 5


def test_empty_is_zeros():
    for got in (T.empty([3, 4], **CPU),
                T.empty_like(torch.ones(3, 4) * 7)):
        assert bool((got == 0).all())


@pytest.mark.parametrize("name,dtype", [("zeros_like", None),
                                        ("ones_like", "int64"),
                                        ("empty_like", None),
                                        ("full_like", "int64")])
def test_like(name, dtype):
    x = rng().standard_normal((2, 3)).astype(np.float32)
    args = [x, 2.5] if name == "full_like" else [x]
    check(name, args, {"dtype": dtype})


@pytest.mark.parametrize("case", ["vector_offset", "padding_neg",
                                  "matrix_offset"])
def test_diag(case):
    r = rng(1)
    v = r.standard_normal(3).astype(np.float32)
    m = r.standard_normal((4, 4)).astype(np.float32)
    kw = {"vector": {}, "vector_offset": {"offset": 1},
          "padding": {"padding_value": 9.0},
          "padding_neg": {"offset": -2, "padding_value": -1.0},
          "matrix": {}, "matrix_offset": {"offset": -1}}[case]
    check("diag", [m if case.startswith("matrix") else v], kw,
          grad=(0,) if case != "matrix_offset" else ())


@pytest.mark.parametrize("name,kw", [("diagflat", {"offset": 1}),
                                     ("tril", {"diagonal": -1}),
                                     ("triu", {"diagonal": 1})])
def test_triangles(name, kw):
    x = rng(2).standard_normal((3, 4)).astype(np.float32)
    if name == "diagflat":
        x = x[0]
    check(name, [x], kw, grad=(0,) if name == "triu" else ())


def test_meshgrid_is_ij():
    a = np.arange(3, dtype=np.float32)
    b = np.arange(4, dtype=np.float32)
    check("meshgrid", [a, b])
    check("meshgrid", [[a, b]])


def test_assign_copy_and_into_output():
    x = rng(3).standard_normal((2, 3)).astype(np.float32)
    check("assign", [x], grad=(0,))
    want = J.assign([1.0, 2.0])
    assert_same(T.assign([1.0, 2.0], **CPU), want)     # float64, numpy's
    out = torch.zeros(2, 3)
    res = T.assign(torch.from_numpy(x).requires_grad_(), out)
    assert res is out and not out.requires_grad
    np.testing.assert_array_equal(out.numpy(), x)


def test_clone_numel_tolist_create_tensor():
    x = rng(4).standard_normal((2, 5)).astype(np.float32)
    check("clone", [x], grad=(0,))
    check("numel", [x])
    assert T.tolist(torch.from_numpy(x)) == J.tolist(paddle.to_tensor(x))
    assert_same(T.create_tensor("int32", **CPU), J.create_tensor("int32"))


def test_create_parameter_uses_the_ports_factory():
    p = T.create_parameter([3, 4], "float32", **CPU)
    assert isinstance(p, torch.nn.Parameter) and p.shape == (3, 4)
    b = T.create_parameter([4], "float32", is_bias=True, **CPU)
    assert bool((b == 0).all())


def test_complex():
    r = rng(5)
    check("complex", [r.standard_normal(3).astype(np.float32),
                      r.standard_normal(3).astype(np.float32)])


def test_creation_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: T.zeros([2]), lambda: T.to_tensor([1.0]),
                 lambda: T.arange(3), lambda: T.linspace(0, 1, 3),
                 lambda: T.full([2], 1.0), lambda: T.eye(2)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()


def test_dtype_map_and_default_dtype():
    assert tdtype.convert_dtype("fp16") == torch.float16
    assert tdtype.convert_dtype("paddle.float32") == torch.float32
    assert tdtype.convert_dtype(np.float64) == torch.float64
    assert tdtype.convert_dtype("int") == torch.int32
    assert tdtype.convert_dtype(torch.bfloat16) == torch.bfloat16
    with pytest.raises(ValueError):
        tdtype.convert_dtype("not_a_dtype")
    assert tdtype.get_default_dtype() == "float32"
    tdtype.set_default_dtype("float64")
    try:
        assert T.to_tensor(1.5, **CPU).dtype == torch.float64
    finally:
        tdtype.set_default_dtype("float32")
    with pytest.raises(TypeError):
        tdtype.set_default_dtype("int32")


LOGIC = ["equal", "not_equal", "greater_than", "greater_equal", "less_than",
         "less_equal", "logical_and", "logical_or", "logical_xor",
         "bitwise_and", "bitwise_or", "bitwise_xor"]


def _logic_args(name, kind):
    r = rng(6)
    if name.startswith("bitwise"):
        if kind == "bool":
            return [r.integers(0, 2, 8).astype(bool),
                    r.integers(0, 2, 8).astype(bool)]
        return [r.integers(-5, 6, 8).astype(np.int32),
                r.integers(-5, 6, 8).astype(np.int64)]
    a = r.integers(-2, 3, 8).astype(np.float32)
    b = r.integers(-2, 3, 8).astype(np.float32)
    if kind == "bool":
        return [a > 0, b > 0]
    if kind == "int_pyfloat":
        return [a.astype(np.int32), 0.5]
    return [a, BF16(b)]


KINDS = ["bool", "int_pyfloat", "mixed"]


@pytest.mark.parametrize("name,kind", [(n, KINDS[i % 3]) for i, n in
                                       enumerate(LOGIC)]
                         + [("equal", "mixed"), ("less_than", "bool")])
def test_binary_logic(name, kind):
    check(name, _logic_args(name, kind))


@pytest.mark.parametrize("name,x", [
    ("logical_not", np.array([0, 1, 2], np.int32)),
    ("logical_not", np.array([True, False])),
    ("bitwise_not", np.array([0, 5, -3], np.int32)),
    ("bitwise_not", np.array([True, False]))])
def test_unary_logic(name, x):
    check(name, [x])


def test_is_empty_and_is_tensor():
    for shape in ((0, 3), (2, 3)):
        x = np.zeros(shape, np.float32)
        check("is_empty", [x])
    assert T.is_tensor(torch.ones(1)) and not T.is_tensor(np.ones(1))
