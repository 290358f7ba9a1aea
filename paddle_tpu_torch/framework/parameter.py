"""``Parameter``: ``torch.nn.Parameter`` with the reference's attributes
(port of ``paddle_tpu.core.Parameter`` :560 and the attributes
``nn/initializer/_create_param`` sets, ``:210-236``).

- ``name``: the optimizer's ``state_dict`` keys are built from it; a
  generated ``generated_tensor_{n}`` unless one is given;
- ``trainable``: whether an optimizer updates it, kept equal to
  ``requires_grad``;
- ``optimize_attr``: ``{"learning_rate": scale}`` of the optimizer's rate;
- ``regularizer``: a coupled decay that wins over the optimizer's;
- ``is_bias``.

``gradient()`` gives the gradient as a numpy array (None without one)
and ``clear_gradient(set_to_zero=False)`` drops it or makes it zeros; a
row-sparse gradient (``embedding(sparse=True)``) is densified by both,
as the reference's are (``core.py:490-502``).

Arithmetic on a ``Parameter`` gives plain tensors, as on any
``nn.Parameter``.  A deep copy or a pickled copy keeps every attribute,
the name included, as the reference's ``copy.deepcopy`` does (so the
layers ``TransformerEncoder`` clones share their template's names).
"""
from __future__ import annotations

import copy
import itertools

import torch
from torch import nn

__all__ = ["Parameter", "clear_gradient"]

_count = itertools.count(1)


class Parameter(nn.Parameter):
    name = None      # shadows TensorBase.name, which cannot be set

    def __new__(cls, data, trainable=True, name=None, regularizer=None,
                learning_rate=1.0, is_bias=False):
        p = super().__new__(cls, data, requires_grad=bool(trainable))
        p.name = name if name is not None else (
            f"generated_tensor_{next(_count)}")
        p.trainable = bool(trainable)
        p.optimize_attr = {"learning_rate": learning_rate}
        p.regularizer = regularizer
        p.is_bias = is_bias
        return p

    def gradient(self):
        if self.grad is None:
            return None
        from paddle_tpu_torch.framework.selected_rows import dense
        return dense(self.grad).detach().cpu().numpy()

    def clear_gradient(self, set_to_zero=False):
        clear_gradient(self, set_to_zero)

    clear_grad = clear_gradient

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            memo[id(self)] = _rebuild(
                type(self), self.data.clone(
                    memory_format=torch.preserve_format),
                self.requires_grad, copy.deepcopy(self.__dict__, memo))
        return memo[id(self)]

    def __reduce_ex__(self, proto):
        # nn.Parameter's would rebuild a plain nn.Parameter, on which the
        # name cannot be set
        return (_rebuild, (type(self), self.data, self.requires_grad,
                           self.__dict__))


def _rebuild(cls, data, requires_grad, attrs):
    p = cls(data, name=attrs["name"])
    p.__dict__.update(attrs)
    p.requires_grad_(requires_grad)
    return p


def clear_gradient(p, set_to_zero=False):
    """Drop ``p``'s gradient, or with ``set_to_zero`` make it dense
    zeros."""
    if set_to_zero and p.grad is not None:
        if p.grad.is_sparse:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()
    else:
        p.grad = None
