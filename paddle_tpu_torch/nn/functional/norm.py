"""``layer_norm`` (port of paddle_tpu/nn/functional/norm.py, what
nn/layer/norm.py needs)."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Layer normalisation over the trailing ``normalized_shape`` dims
    (reference ``:113``), statistics in f32 for a bf16 input."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)
