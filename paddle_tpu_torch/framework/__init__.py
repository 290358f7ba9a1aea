"""Framework plumbing of the PyTorch port (flags, io, dtypes, crypto, the
host planes) and the reference's re-exports
(``paddle_tpu/framework/__init__.py:9-30``): ``monitor``, ``chaos`` and
``observability`` bound as the reference binds them, ``locks``,
``health`` and ``numerics`` importable as submodules,
``auto_checkpoint``, ``incident``, ``resilient`` (its
``ResilientTrainStep``) and the top level's objects of the same names
resolved at first use (the top level imports this package, and
``auto_checkpoint`` imports ``distributed``).  The operations planes
(``blame``, ``runlog``, ``collector``, ``autopilot``) are submodules.
The reference's framework modules still to port raise, naming their
ROADMAP item."""
from paddle_tpu_torch._pending import pending_modules
from paddle_tpu_torch.framework import flags  # noqa: F401
from paddle_tpu_torch.framework import monitor  # noqa: F401
from paddle_tpu_torch.framework import chaos  # noqa: F401
from paddle_tpu_torch.framework import observability  # noqa: F401

_REEXPORTS = ("save", "load", "seed", "Generator", "default_generator",
              "get_rng_state", "set_rng_state", "Parameter", "Tensor",
              "no_grad", "CPUPlace", "CUDAPlace", "get_default_dtype",
              "set_default_dtype", "in_dygraph_mode")

_pending_module = pending_modules("paddle_tpu_torch.framework", {
    "errors": ("7", "the error types"),
    "analysis": ("8", "the analysis planes")})
_SUBMODULES = ("auto_checkpoint", "numerics", "incident", "resilient")


def __getattr__(name):
    import importlib
    if name in _SUBMODULES:
        return importlib.import_module(f"paddle_tpu_torch.framework.{name}")
    if name == "ResilientTrainStep":
        return importlib.import_module(
            "paddle_tpu_torch.framework.resilient").ResilientTrainStep
    if name in _REEXPORTS:
        import paddle_tpu_torch
        return getattr(paddle_tpu_torch, name)
    return _pending_module(name)


def __dir__():
    return sorted(list(globals()) + list(_REEXPORTS) + list(_SUBMODULES)
                  + ["ResilientTrainStep"])
