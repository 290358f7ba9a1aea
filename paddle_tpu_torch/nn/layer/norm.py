"""``LayerNorm`` and the batch norms (port of paddle_tpu/nn/layer/norm.py
``_BatchNormBase`` :23-90 and ``LayerNorm`` :119).

A batch norm keeps its running statistics as the buffers ``_mean``
(zeros) and ``_variance`` (ones), the reference's state-dict keys
(``bn1._mean``, ...), in f32 whatever the dtype of the input; its weight
is ones and its bias zeros.  ``train()`` and ``eval()`` (PyTorch's
``training`` flag) choose the batch's statistics, which update the
buffers in place, or the running ones.  ``SyncBatchNorm`` is not ported.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import Constant
from paddle_tpu_torch.nn.layer.common import make_param

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


class LayerNorm(nn.Module):
    """Layer normalisation over the trailing ``normalized_shape`` dims with
    a weight of ones and a bias of zeros (``weight_attr`` / ``bias_attr``
    False drop them, a ``ParamAttr`` overrides them), created on the card
    unless ``device="cpu"``."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = make_param(self._normalized_shape, weight_attr,
                                 Constant(1.0), device=device)
        self.bias = make_param(self._normalized_shape, bias_attr,
                               is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class _BatchNormBase(nn.Module):
    """Batch normalisation over ``num_features`` channels (Paddle's
    ``momentum``: the share of the running statistics kept each step)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        self.weight = make_param([num_features], weight_attr, Constant(1.0),
                                 device=dev)
        self.bias = make_param([num_features], bias_attr, is_bias=True,
                               device=dev)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The legacy ``fluid.dygraph.BatchNorm`` signature (reference
    ``:55``): ``act`` names an activation of ``nn.functional`` applied
    after the norm."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass
