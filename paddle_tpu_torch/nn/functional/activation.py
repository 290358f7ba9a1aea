"""Activations (port of paddle_tpu/nn/functional/activation.py): ``relu``
and ``gelu`` for the transformer and vision layers, ``softmax`` and
``log_softmax`` for the seq2seq head and the beam step, ``tanh`` and
``sigmoid`` for the recurrent cells."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["relu", "gelu", "softmax", "log_softmax", "tanh", "sigmoid"]


def relu(x, name=None):
    return F.relu(x)


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, tanh-approximated with
    ``approximate=True``, as the reference's ``jax.nn.gelu``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _as_dtype(dtype):
    """A torch dtype from a torch dtype or a name ("float32", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype).lower().replace("paddle.", ""), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax along ``axis``, of x cast to ``dtype`` first when given
    (reference ``:143``)."""
    if dtype is not None:
        x = x.to(_as_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Log-softmax along ``axis``, of x cast to ``dtype`` first when given
    (reference ``:155``)."""
    if dtype is not None:
        x = x.to(_as_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def tanh(x, name=None):
    return torch.tanh(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)
