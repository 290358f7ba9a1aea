"""Weight-decay regularizers (port of paddle_tpu/regularizer.py :16-35):
``L1Decay`` and ``L2Decay``, the term an optimizer adds to a gradient.

Given to an optimizer as ``weight_decay`` (every parameter) or to a
parameter as ``ParamAttr(regularizer=...)``, which wins over the
optimizer's (``Optimizer._apply_decay``).
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __call__(self, param):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """``coeff * sign(param)``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * torch.sign(param)

    def __repr__(self):
        return f"L1Decay({self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """``coeff * param``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * param

    def __repr__(self):
        return f"L2Decay({self.coeff})"
