"""Comparisons and logical / bitwise operations (port of
paddle_tpu/tensor/logic.py).

The comparisons and the logical operations give bool; the bitwise ones
work on bool and integer tensors.  Operands are promoted as the
reference promotes them (a Python float beside an integer tensor
compares in float64).  None of these outputs takes a gradient.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.tensor._common import promote

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "is_empty",
    "is_tensor",
]


def _binary(fn, name):
    def op(x, y, name=None):
        _, _, (a, b) = promote(x, y)
        return fn(a, b)
    op.__name__ = name
    op.__doc__ = f"``{fn.__name__}`` of x and y after the reference's " \
                 "promotion."
    return op


equal = _binary(torch.eq, "equal")
not_equal = _binary(torch.ne, "not_equal")
greater_than = _binary(torch.gt, "greater_than")
greater_equal = _binary(torch.ge, "greater_equal")
less_than = _binary(torch.lt, "less_than")
less_equal = _binary(torch.le, "less_equal")
logical_and = _binary(torch.logical_and, "logical_and")
logical_or = _binary(torch.logical_or, "logical_or")
logical_xor = _binary(torch.logical_xor, "logical_xor")
bitwise_and = _binary(torch.bitwise_and, "bitwise_and")
bitwise_or = _binary(torch.bitwise_or, "bitwise_or")
bitwise_xor = _binary(torch.bitwise_xor, "bitwise_xor")


def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(x)


def is_empty(x, name=None):
    """A 0-d bool tensor on x's device: True if x has no element."""
    return torch.full((), x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
