"""Framework plumbing of the PyTorch port (flags, io, dtypes, crypto) and
the reference's re-exports (``paddle_tpu/framework/__init__.py:15-30``),
each the object of the same name at the package's top level, resolved at
first use (the top level imports this package)."""

_REEXPORTS = ("save", "load", "seed", "Generator", "default_generator",
              "get_rng_state", "set_rng_state", "Parameter", "Tensor",
              "no_grad", "CPUPlace", "CUDAPlace", "get_default_dtype",
              "set_default_dtype", "in_dygraph_mode")


def __getattr__(name):
    if name in _REEXPORTS:
        import paddle_tpu_torch
        return getattr(paddle_tpu_torch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_REEXPORTS))
