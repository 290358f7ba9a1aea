"""``Linear``, ``Dropout``, ``Embedding`` and ``Flatten`` (port of
paddle_tpu/nn/layer/common.py).

``Linear`` keeps the reference's ``(in_features, out_features)`` weight
layout, so a reference layer's weights carry across as a copy
(models/convert.py ``load_named_params``).  Parameters are created on the
card unless ``device="cpu"`` is asked for.  ``weight_attr`` and
``bias_attr`` take None (the defaults: Xavier-uniform weight, zero bias)
or ``bias_attr=False`` (no bias); a ``ParamAttr`` is not ported and
raises.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F

__all__ = ["Linear", "Dropout", "Embedding", "Flatten"]


def _check_attr(attr, what):
    if attr is not None and attr is not False:
        raise NotImplementedError(
            f"{what}={attr!r}: ParamAttr is not ported; pass None (the "
            "default initializer) or, for a bias, False")


class Linear(nn.Module):
    """y = x @ W + b with W (in_features, out_features) (reference
    ``:60``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        _check_attr(weight_attr, "weight_attr")
        if weight_attr is False:
            raise ValueError("Linear needs a weight")
        _check_attr(bias_attr, "bias_attr")
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(in_features, out_features, device=dev)))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(out_features, device=dev)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Dropout(nn.Module):
    """Dropout (reference ``:95``) in training mode, the identity in
    evaluation mode; the keep mask is drawn from ``generator`` (the default
    generator of the input's device when None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Embedding(nn.Module):
    """A (num_embeddings, embedding_dim) table looked up by integer ids
    (reference ``:141``): Xavier-uniform, the ``padding_idx`` row zeroed at
    construction (a negative one counts from the end) and its lookups zero.
    ``sparse=True`` is not ported and raises."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None):
        super().__init__()
        _check_attr(weight_attr, "weight_attr")
        if weight_attr is False:
            raise ValueError("Embedding needs a weight")
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True): the SelectedRows gradient is not "
                "ported; use sparse=False")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None or
                             padding_idx >= 0 else num_embeddings + padding_idx)
        weight = nn.init.xavier_uniform_(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device)))
        if self._padding_idx is not None:
            weight[self._padding_idx] = 0.0
        self.weight = nn.Parameter(weight)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(nn.Module):
    """Flattens dims ``start_axis`` to ``stop_axis`` into one (reference
    ``:167``)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)
