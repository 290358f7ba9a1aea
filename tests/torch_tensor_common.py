"""Shared pieces of the tensor-library tests (test_torch_tensor_*.py):
one call of a function in both packages on the same numpy inputs, and
the comparison of its outputs (values and dtypes) and of the gradients
of ``sum(out * w)`` for a seeded w.

Tolerances, by output dtype:
- bool and integer outputs (indices, counts, comparisons): bitwise;
- float32: 1e-5 relative and 1e-6 absolute: the two libraries' ``exp``,
  ``log``, ``pow``, ... differ in the last bit or two (1.2e-7 each), and
  their reductions sum in other orders over the tests' 32 values;
- float64: 1e-12 relative and absolute;
- bfloat16: 1.6e-2 relative and absolute (two bf16 ulps near 1): a bf16
  result is rounded once from float32 work that differs in its last bits;
- gradients: 1e-5 relative and absolute in float32.
"""
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch.tensor as T

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "float64": dict(rtol=1e-12, atol=1e-12),
       "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2),
       "float16": dict(rtol=2e-3, atol=2e-3),
       "complex64": dict(rtol=1e-5, atol=1e-6)}
TOL_GRAD = dict(rtol=1e-5, atol=1e-5)


class BF16:
    """A bfloat16 input, made from float32 values in both packages."""

    def __init__(self, arr):
        self.arr = np.asarray(arr, np.float32)


def rng(seed=0):
    return np.random.default_rng(seed)


def _ref_in(a, grad):
    if isinstance(a, BF16):
        t = paddle.to_tensor(a.arr).astype("bfloat16")
    elif isinstance(a, np.ndarray):
        t = paddle.to_tensor(a)
    elif isinstance(a, (list, tuple)) and a and isinstance(
            a[0], (np.ndarray, BF16)):
        return [_ref_in(v, grad) for v in a]
    else:
        return a
    t.stop_gradient = not grad
    return t


def _port_in(a, grad):
    if isinstance(a, BF16):
        t = torch.from_numpy(a.arr.copy()).to(torch.bfloat16)
    elif isinstance(a, np.ndarray):
        t = torch.from_numpy(a.copy())
    elif isinstance(a, (list, tuple)) and a and isinstance(
            a[0], (np.ndarray, BF16)):
        return [_port_in(v, grad) for v in a]
    else:
        return a
    if grad:
        t.requires_grad_()
    return t


def flat(out):
    if isinstance(out, (tuple, list)):
        return [o for v in out for o in flat(v)]
    return [out]


def ref_np(t):
    if isinstance(t, paddle.Tensor):
        t = t._data
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def port_np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def dtype_name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.dtype(t._data.dtype) if hasattr(t, "_data") else
               np.asarray(t).dtype)


def assert_same(got, want, what="", tol=None):
    """Dtype equal; bool / integer values bitwise; floats within the
    dtype's tolerance (NaN where NaN)."""
    name = dtype_name(want)
    assert dtype_name(got) == name, f"{what}: dtype {dtype_name(got)} != " \
                                    f"{name}"
    g, w = port_np(got), ref_np(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    if name in TOL:
        np.testing.assert_allclose(g, w, err_msg=what, equal_nan=True,
                                   **(tol or TOL[name]))
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def run(fn, args, kwargs=None, ref_fn=None):
    """(port outputs, reference outputs) of one call on the same
    inputs, without gradients."""
    kwargs = kwargs or {}
    ref_fn = ref_fn or getattr(J, fn)
    port_fn = getattr(T, fn)
    want = ref_fn(*[_ref_in(a, False) for a in args], **kwargs)
    got = port_fn(*[_port_in(a, False) for a in args], **kwargs)
    return got, want


def check(fn, args, kwargs=None, grad=None, tol=None, ref_fn=None,
          port_fn=None):
    """Call ``fn`` in both packages on ``args`` (numpy arrays, BF16, or
    Python values passed as they are); compare every output; with
    ``grad`` (positions of float inputs), backward ``sum(out * w)`` over
    the float outputs and compare those inputs' gradients."""
    kwargs = kwargs or {}
    grad = tuple(grad or ())
    ref_fn = ref_fn or getattr(J, fn)
    port_fn = port_fn or getattr(T, fn)
    jargs = [_ref_in(a, i in grad) for i, a in enumerate(args)]
    targs = [_port_in(a, i in grad) for i, a in enumerate(args)]
    want, got = flat(ref_fn(*jargs, **kwargs)), flat(port_fn(*targs,
                                                             **kwargs))
    assert len(got) == len(want), f"{fn}: {len(got)} outputs != " \
                                  f"{len(want)}"
    for k, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"{fn} output {k}", tol)
    if not grad:
        return got, want
    r = rng(99)
    jloss, tloss = None, None
    for g, w in zip(got, want):
        if not (g.is_floating_point() and g.requires_grad):
            continue
        wt = r.standard_normal(tuple(g.shape)).astype(np.float32)
        jl = (w * paddle.to_tensor(wt).astype(w.dtype)).sum()
        tl = (g * torch.from_numpy(wt).to(g.dtype)).sum()
        jloss = jl if jloss is None else jloss + jl
        tloss = tl if tloss is None else tloss + tl
    jloss.backward()
    tloss.backward()
    for i in grad:
        jg, tg = jargs[i].grad, targs[i].grad
        np.testing.assert_allclose(
            port_np(tg), ref_np(jg), equal_nan=True,
            err_msg=f"{fn} gradient of input {i}", **TOL_GRAD)
    return got, want
