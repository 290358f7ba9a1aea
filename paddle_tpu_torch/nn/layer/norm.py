"""The norm layers (port of paddle_tpu/nn/layer/norm.py): ``LayerNorm``
(:119), the batch norms (``_BatchNormBase`` :23-90), ``GroupNorm``,
``InstanceNorm1D/2D/3D``, ``LocalResponseNorm`` and ``SpectralNorm``
(:149-260).

A batch norm keeps its running statistics as the buffers ``_mean``
(zeros) and ``_variance`` (ones), the reference's state-dict keys
(``bn1._mean``, ...), in f32 whatever the dtype of the input; its weight
is ones and its bias zeros.  ``train()`` and ``eval()`` (PyTorch's
``training`` flag) choose the batch's statistics, which update the
buffers in place, or the running ones.  ``SyncBatchNorm`` is the
reference's (``:92-115``): a batch norm with no forward of its own, and
``convert_sync_batchnorm``, which swaps every other batch norm of a layer
tree for one, carrying weight, bias and running statistics across (and
the training flag).  Its statistics span the ranks only where every
batch norm's do, inside ``parallel.ShardedTrainStep`` (the global batch);
under the ``dp_meta`` steps each rank normalises by its own slice.

``GroupNorm`` and the instance norms hold a weight of ones and a bias of
zeros (``weight_attr`` / ``bias_attr`` False drop them) and no running
statistics.  ``SpectralNorm(weight_shape)`` divides the weight it is
called on by its largest singular value, estimated by ``power_iters``
steps of the power iteration along ``dim`` from the vectors ``weight_u``
and ``weight_v``: Xavier-uniform parameters that take no gradient and
are never updated, as in the reference (each call starts from them and
drops its result); the gradient flows through the iteration to the
weight.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.amp import _op_scope, amp_cast_for_op
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import Constant, _create_param
from paddle_tpu_torch.nn.layer.common import make_param
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm"]


class LayerNorm(Layer):
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


class _BatchNormBase(Layer):
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


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm (reference ``nn/layer/norm.py:92``): the
    statistics of the global batch where the step's program spans it
    (``ShardedTrainStep``), the rank's own slice's elsewhere, as every
    batch norm."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm below it (not ``layer`` itself)
        replaced by a ``SyncBatchNorm`` of its features, momentum,
        epsilon and data format, its weight, bias, mean and variance
        copied in (reference ``:99-115``); returns ``layer``."""
        for name, sub in list(layer.named_children()):
            if isinstance(sub, _BatchNormBase) and not isinstance(
                    sub, SyncBatchNorm):
                new = SyncBatchNorm(sub._num_features, sub._momentum,
                                    sub._epsilon,
                                    data_format=sub._data_format,
                                    device=sub._mean.device)
                with torch.no_grad():
                    for dst, src in ((new.weight, sub.weight),
                                     (new.bias, sub.bias),
                                     (new._mean, sub._mean),
                                     (new._variance, sub._variance)):
                        if src is not None:
                            dst.data = src.detach().clone()
                new.train(sub.training)
                setattr(layer, name, new)
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


class GroupNorm(Layer):
    """``F.group_norm`` over ``num_groups`` groups of ``num_channels``
    (reference ``:149``), created on the card unless ``device="cpu"``."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        dev = resolve_device(device)
        self.weight = make_param([num_channels], weight_attr, Constant(1.0),
                                 device=dev)
        self.bias = make_param([num_channels], bias_attr, is_bias=True,
                               device=dev)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)

    def extra_repr(self):
        return (f"num_groups={self._num_groups}, "
                f"num_channels={self._num_channels}")


class _InstanceNormBase(Layer):
    """``F.instance_norm`` with ``num_features`` channels (reference
    ``:176``); ``momentum`` and ``data_format`` are read by nothing, as in
    the reference."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        dev = resolve_device(device)
        self.weight = make_param([num_features], weight_attr, Constant(1.0),
                                 device=dev)
        self.bias = make_param([num_features], bias_attr, is_bias=True,
                               device=dev)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    """``F.local_response_norm`` with its arguments held (reference
    ``:212``)."""

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


def _l2(t):
    return torch.sqrt(torch.sum(t * t))


class SpectralNorm(Layer):
    """The weight it is called on divided by its spectral norm (reference
    ``:227-260``); one op ``spectral_norm`` for ``amp.auto_cast``."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32", device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        dev = resolve_device(device)
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.weight_u = _create_param([h], dtype, device=dev)
        self.weight_v = _create_param([w], dtype, device=dev)

    def forward(self, weight):
        weight, u, v = amp_cast_for_op(
            "spectral_norm", [weight, self.weight_u.detach(),
                              self.weight_v.detach()])
        with _op_scope():
            wm = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                      -1)
            for _ in range(self._power_iters):
                v = wm.T @ u
                v = v / (_l2(v) + self._eps)
                u = wm @ v
                u = u / (_l2(u) + self._eps)
            return weight / (u @ wm @ v)
