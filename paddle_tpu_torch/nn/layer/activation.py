"""``ReLU`` (port of paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["ReLU"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)
