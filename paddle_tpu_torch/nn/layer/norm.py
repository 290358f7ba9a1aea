"""``LayerNorm`` (port of paddle_tpu/nn/layer/norm.py ``LayerNorm`` :119,
what nn/layer/transformer.py needs)."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import _check_attr

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """Layer normalisation over the trailing ``normalized_shape`` dims with
    a weight of ones and a bias of zeros (``weight_attr`` / ``bias_attr``
    False drop them), created on the card unless ``device="cpu"``."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        _check_attr(weight_attr, "weight_attr")
        _check_attr(bias_attr, "bias_attr")
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        dev = resolve_device(device)
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, device=dev)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, device=dev)))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
