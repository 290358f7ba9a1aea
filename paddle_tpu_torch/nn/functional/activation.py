"""``relu`` and ``gelu`` (port of paddle_tpu/nn/functional/activation.py,
what the transformer and vision layers need)."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["relu", "gelu"]


def relu(x, name=None):
    return F.relu(x)


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, tanh-approximated with
    ``approximate=True``, as the reference's ``jax.nn.gelu``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")
