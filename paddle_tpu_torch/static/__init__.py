"""Static-graph compatibility surface (port of paddle_tpu/static).

The reference's static mode has no graph of its own: capture
(``jit.to_static``) is the static mode.  ``enable_static`` flips a flag
that ``in_dygraph_mode`` reads, ``InputSpec`` feeds ``jit.to_static`` and
``jit.save``, ``Program`` and ``Executor`` raise and name the capture
path, and ``save_inference_model`` / ``load_inference_model`` write and
read ``jit.save``'s artifact.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["InputSpec", "enable_static", "disable_static"]

_state = threading.local()


def _in_static_mode() -> bool:
    return getattr(_state, "static", False)


def enable_static():
    _state.static = True


def disable_static():
    _state.static = False


class InputSpec:
    """Shape and dtype of one input to a capture (reference ``:38``): a
    dim given as None or -1 is dynamic."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype!r})"

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, str(tensor.dtype).replace("torch.", ""),
                   name)

    def torch_dtype(self) -> torch.dtype:
        from paddle_tpu_torch.framework.dtype import convert_dtype
        return convert_dtype(self.dtype)


class Program:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "ProgramDesc-style static graphs do not exist in "
            "paddle_tpu_torch; use paddle_tpu_torch.jit.to_static "
            "(torch.export capture) instead")


class Executor:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "the C++ Executor does not exist in paddle_tpu_torch; captured "
            "functions run their exported graph (see paddle_tpu_torch.jit)")


from paddle_tpu_torch.static import nn  # noqa: E402,F401
from paddle_tpu_torch.static.nn import (  # noqa: E402,F401
    case, cond, switch_case, while_loop)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    """``jit.save``'s artifact under the static API's name (reference
    ``:74``): ``fetch_vars`` is the Layer to export (or carries it as
    ``.model``), ``feed_vars`` its ``InputSpec``s."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn.layer.layers import Layer
    layer = fetch_vars if isinstance(fetch_vars, Layer) else \
        getattr(fetch_vars, "model", None)
    if layer is None:
        raise TypeError(
            "save_inference_model(fetch_vars=...) must be the Layer to "
            "export (there is no Program to prune in paddle_tpu_torch; the "
            "Layer's captured forward plays that role)")
    specs = list(feed_vars) if feed_vars is not None else None
    jit.save(layer, path_prefix, input_spec=specs)
    return path_prefix


def load_inference_model(path_prefix, executor=None, **kwargs):
    """The ``TranslatedLayer`` of ``save_inference_model``'s artifact
    (reference ``:95``); ``device=`` as ``jit.load``."""
    from paddle_tpu_torch import jit
    return jit.load(path_prefix, **kwargs)


__all__ += ["save_inference_model", "load_inference_model", "Program",
            "Executor", "nn", "case", "cond", "switch_case", "while_loop"]
