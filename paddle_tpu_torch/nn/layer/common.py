"""``ParamAttr`` and the common layers (port of
paddle_tpu/nn/layer/common.py): ``Linear``, ``Identity``, the dropouts,
``Embedding``, ``Flatten``, the upsampling layers, ``Bilinear``, the
distances, the pads, ``Unfold``, ``Fold`` and ``PixelShuffle``.

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

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import (Initializer, XavierUniform,
                                             _create_param)
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["ParamAttr", "Linear", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Embedding", "Flatten", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Bilinear",
           "CosineSimilarity", "PairwiseDistance", "Pad1D", "Pad2D", "Pad3D",
           "ZeroPad2D", "Identity", "Unfold", "Fold", "PixelShuffle"]


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


class Linear(Layer):
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


class Dropout(Layer):
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


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout2D(Layer):
    """Drops whole channels in training mode (reference ``:108``)."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(Dropout2D):
    def __init__(self, p=0.5, data_format="NCDHW", name=None,
                 generator=None):
        super().__init__(p, data_format, name, generator)

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training,
                               generator=self.generator)


class Embedding(Layer):
    """A (num_embeddings, embedding_dim) table looked up by integer ids
    (reference ``:141``): Xavier-uniform, the ``padding_idx`` row zeroed at
    construction (a negative one counts from the end) and its lookups zero.
    ``sparse=True`` gives the table a row-sparse gradient in the eager
    loop (``F.embedding``)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None):
        super().__init__()
        if weight_attr is False:
            raise ValueError("Embedding needs a weight")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._sparse = sparse
        self._padding_idx = (padding_idx if padding_idx is None or
                             padding_idx >= 0 else num_embeddings + padding_idx)
        self.weight = make_param([num_embeddings, embedding_dim],
                                 weight_attr, XavierUniform(), device=device)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    """Flattens dims ``start_axis`` to ``stop_axis`` into one (reference
    ``:167``)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    """``F.interpolate`` with its arguments held (reference ``:176``)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class Bilinear(Layer):
    """out = x1 @ W[o] @ x2 + b with W (out, in1, in2), Xavier-uniform, and
    a zero bias (reference ``:209``)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, device=None):
        super().__init__()
        if weight_attr is False:
            raise ValueError("Bilinear needs a weight")
        self.weight = make_param([out_features, in1_features, in2_features],
                                 weight_attr, XavierUniform(), device=device)
        self.bias = make_param([out_features], bias_attr, is_bias=True,
                               device=device)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class _PadNd(Layer):
    _width = 1

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding = ([padding] * 2 * self._width
                        if isinstance(padding, int) else list(padding))
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    _width = 2


class Pad3D(_PadNd):
    _width = 3

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)
