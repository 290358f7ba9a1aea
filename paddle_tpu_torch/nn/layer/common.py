"""``ParamAttr``, ``Linear``, ``Dropout``, ``Embedding`` and ``Flatten``
(port of paddle_tpu/nn/layer/common.py).

``Linear`` keeps the reference's ``(in_features, out_features)`` weight
layout, so a reference layer's weights carry across as a copy
(models/convert.py ``load_named_params``).  Parameters are created on the
card unless ``device="cpu"`` is asked for.  Every layer's ``weight_attr``
and ``bias_attr`` take what the reference's ``ParamAttr._to_attr`` takes:
None (the layer's default initializer), False (no bias), a ``ParamAttr``,
an ``nn.initializer`` instance or a ``str`` name; the parameter is made by
``nn.initializer._create_param``.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import (Initializer, XavierUniform,
                                             _create_param)

__all__ = ["ParamAttr", "Linear", "Dropout", "Embedding", "Flatten"]


class ParamAttr:
    """How a layer makes one parameter (reference ``:33-59``): its name,
    initializer, learning-rate scale, regularizer and whether it trains.
    ``do_model_average`` and ``need_clip`` are kept and read by nothing,
    as in the reference."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None or isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"bad ParamAttr spec {attr!r}")


def make_param(shape, attr, default_initializer=None, is_bias=False,
               device=None, what="weight"):
    """The layers' one way to a parameter: ``attr`` as ``_to_attr`` reads
    it, None when it is False (no parameter), on ``device``."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    return _create_param(shape, "float32", attr=attr, is_bias=is_bias,
                         default_initializer=default_initializer,
                         device=resolve_device(device))


class Linear(nn.Module):
    """y = x @ W + b with W (in_features, out_features) (reference
    ``:60``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        if weight_attr is False:
            raise ValueError("Linear needs a weight")
        self.in_features = in_features
        self.out_features = out_features
        self.weight = make_param([in_features, out_features], weight_attr,
                                 XavierUniform(), device=device)
        self.bias = make_param([out_features], bias_attr, is_bias=True,
                               device=device)

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
        self.weight = make_param([num_embeddings, embedding_dim],
                                 weight_attr, XavierUniform(), device=device)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

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
