"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module layout.  It imports ``torch`` and ``numpy`` only.  Entry
points run on the card (``"cuda"``) unless the caller passes
``device="cpu"``; the hand-written kernels are built from ``csrc/`` at
first use (``ops/cuda/_build.py``).

The top-level namespace holds the tensor library, the dtypes (as
``torch.dtype``s, so ``x.dtype == paddle_tpu_torch.float32`` holds), the
gradient switches, the random streams, ``save`` / ``load`` and the
reference's compat surface (``paddle_tpu/__init__.py:92-300``).  Where
the reference describes its own platform, these names describe the
port's: ``is_compiled_with_cuda`` says whether this PyTorch was built
with CUDA, ``get_cudnn_version`` gives cuDNN's version, and the places
are ``torch.device``s.  The reference's ``TPUPlace`` and ``XPUPlace``
name devices the port does not have and are left out; so are the names
of modules still to port (``hapi``, ``metric``).  The data plane is bound
as the reference binds it: ``io``, ``dataset``, ``reader`` with
``batch``, and ``text``.  The ported subpackages are bound at
import, as the reference binds its own (``paddle_tpu/__init__.py:55-77``),
and so are the nine tensor submodules (``paddle.linalg.norm``).
"""
from paddle_tpu_torch import amp, autograd, regularizer, tensor  # noqa: F401
from paddle_tpu_torch.autograd import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
    set_grad_enabled_)
from paddle_tpu_torch.device import get_device, set_device  # noqa: F401
from paddle_tpu_torch.framework.dtype import (  # noqa: F401
    convert_dtype, get_default_dtype, set_default_dtype)
from paddle_tpu_torch.framework.flags import get_flags, set_flags  # noqa: F401
from paddle_tpu_torch.framework.io import load, save  # noqa: F401
from paddle_tpu_torch.framework.parameter import Parameter  # noqa: F401
from paddle_tpu_torch.nn.layer.common import ParamAttr  # noqa: F401
from paddle_tpu_torch.tensor import *  # noqa: F401,F403
from paddle_tpu_torch.tensor import add_n, einsum  # noqa: F401
from paddle_tpu_torch.tensor import (  # noqa: F401
    creation, linalg, logic, manipulation, math, random, search, sequence,
    stat)
from paddle_tpu_torch import (  # noqa: F401,E402
    distributed, framework, inference, jit, models, nn, optimizer, parallel,
    quantization, static, vision)
from paddle_tpu_torch.distributed.parallel import DataParallel  # noqa: F401,E402,E501
from paddle_tpu_torch import profiler  # noqa: F401,E402
from paddle_tpu_torch.framework import monitor  # noqa: F401,E402
from paddle_tpu_torch import dataset, io, reader, text  # noqa: F401,E402
from paddle_tpu_torch.reader import batch  # noqa: F401,E402

import torch as _torch

__version__ = "0.1.0"
commit = "torch-cuda"
full_version = __version__

LoDTensor = Tensor          # noqa: F405 -- LoD is the explicit encodings
VarBase = Tensor            # noqa: F405
LoDTensorArray = list

elementwise_add = tensor.add
elementwise_sub = tensor.subtract
elementwise_div = tensor.divide
elementwise_floordiv = tensor.floor_divide
elementwise_mod = tensor.remainder
elementwise_pow = tensor.pow
reduce_sum = tensor.sum
reduce_mean = tensor.mean
reduce_max = tensor.max
reduce_min = tensor.min
reduce_prod = tensor.prod
crop_tensor = tensor.crop


def is_compiled_with_cuda():
    """Whether this PyTorch was built with CUDA (the reference answers
    for its own build, False)."""
    return _torch.backends.cuda.is_built()


def is_compiled_with_xpu():
    return False


def is_compiled_with_tpu():
    return False


def get_cudnn_version():
    """cuDNN's version as an int, None without it."""
    return _torch.backends.cudnn.version()


def device_count():
    """The cards PyTorch sees, 1 (the CPU) without one."""
    return _torch.cuda.device_count() or 1


def CPUPlace():
    return _torch.device("cpu")


def CUDAPlace(device_id=0):
    """The card ``device_id`` as a ``torch.device``; raises without
    CUDA."""
    from paddle_tpu_torch.device import resolve_device
    return resolve_device(f"cuda:{int(device_id)}")


CUDAPinnedPlace = CPUPlace


def in_dynamic_mode():
    """False between ``static.enable_static()`` and ``disable_static()``
    (reference ``framework/__init__.py:29-31``)."""
    return not static._in_static_mode()


in_dygraph_mode = in_dynamic_mode


def enable_static():
    static.enable_static()


def disable_static():
    static.disable_static()


def enable_dygraph(place=None):
    disable_static()


def disable_dygraph():
    enable_static()


def data(name, shape, dtype="float32", lod_level=0):
    """The static data layer as an ``InputSpec`` (reference ``:292``)."""
    return static.InputSpec(shape, dtype=dtype, name=name)


class VarDesc:
    """``VarDesc.VarType.FP32``-style dtype enums (reference
    ``core.py:115``), here the ``torch.dtype``s."""

    class VarType:
        FP16 = _torch.float16
        BF16 = _torch.bfloat16
        FP32 = _torch.float32
        FP64 = _torch.float64
        INT8 = _torch.int8
        UINT8 = _torch.uint8
        INT16 = _torch.int16
        INT32 = _torch.int32
        INT64 = _torch.int64
        BOOL = _torch.bool
        COMPLEX64 = _torch.complex64
        COMPLEX128 = _torch.complex128


def disable_signal_handler():
    pass


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """PyTorch's print options (the reference sets numpy's)."""
    _torch.set_printoptions(precision=precision, threshold=threshold,
                            edgeitems=edgeitems, linewidth=linewidth,
                            sci_mode=sci_mode)


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    """``full`` in fluid's argument order (shape, dtype, value)."""
    return tensor.full(shape, value, dtype=dtype,
                       device="cpu" if force_cpu else None)


def broadcast_shape(x_shape, y_shape):
    return list(_torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def rank(input):
    """x's number of axes, a 0-d int64 tensor on x's device."""
    return _torch.tensor(input.ndim, dtype=_torch.int64, device=input.device)


def shape(input):
    """x's shape, an int32 tensor on x's device."""
    return _torch.tensor(list(input.shape), dtype=_torch.int32,
                         device=input.device)


def has_nan(x):
    return _torch.isnan(x).any()


def has_inf(x):
    return _torch.isinf(x).any()


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A ``full`` tensor that takes no gradient; ``persistable`` is kept
    as an attribute."""
    t = tensor.full(shape, value, dtype=dtype,
                    device="cpu" if force_cpu else None)
    t.persistable = persistable
    return t


def get_tensor_from_selected_rows(x):
    """A row-sparse value (``SelectedRows`` or a sparse COO gradient) as
    a dense tensor; any other tensor as it is."""
    from paddle_tpu_torch.framework.selected_rows import SelectedRows, dense
    if isinstance(x, SelectedRows):
        return x.to_dense()
    return dense(x)


def _inplace(x, out_fn):
    """``x`` given ``out_fn(x)``'s values in place: tracked by autograd
    (the op runs on x's old version, as the reference's ``_inplace_apply``
    keeps it on its tape), but a data-only update for a leaf that
    requires grad, where PyTorch would raise."""
    if x.is_leaf and x.requires_grad:
        with _torch.no_grad():
            return x.copy_(out_fn(x))
    return x.copy_(out_fn(x))


def tanh_(x):
    """tanh in place."""
    return _inplace(x, _torch.tanh)


def scatter_(x, index, updates, overwrite=True):
    """``tensor.scatter`` in place."""
    return _inplace(x, lambda v: tensor.scatter(v, index, updates,
                                                overwrite=overwrite))


def get_cuda_rng_state():
    """The default stream's state on each card, a list."""
    return [tensor.random.default_generator.get_state(f"cuda:{i}")
            for i in range(_torch.cuda.device_count())]


def set_cuda_rng_state(state):
    for i, s in enumerate(state):
        tensor.random.default_generator.set_state(s, f"cuda:{i}")


# the dtypes last: ``bool`` shadows the builtin from here on
float16 = _torch.float16
bfloat16 = _torch.bfloat16
float32 = _torch.float32
float64 = _torch.float64
int8 = _torch.int8
uint8 = _torch.uint8
int16 = _torch.int16
int32 = _torch.int32
int64 = _torch.int64
complex64 = _torch.complex64
complex128 = _torch.complex128
bool = _torch.bool  # noqa: A001 -- the reference's paddle.bool
