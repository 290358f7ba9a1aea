"""``Conv1D``, ``Conv2D`` and ``Conv3D`` (port of
paddle_tpu/nn/layer/conv.py ``_ConvNd`` :23-100).

The weight is (out, in / groups) + kernel, drawn Xavier-uniform with
``fan_in = in / groups * prod(kernel)`` and ``fan_out = out *
prod(kernel)`` (reference nn/initializer/__init__.py:39-51), the bias is
zero (``bias_attr=False``: none); a ``ParamAttr`` or an initializer
overrides either (``nn.layer.common.make_param``).  Parameters are created
on the card unless ``device="cpu"``.  Only ``padding_mode="zeros"`` is ported; the
transposed convolutions are not.
"""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.conv import _tuplify
from paddle_tpu_torch.nn.initializer import XavierUniform
from paddle_tpu_torch.nn.layer.common import make_param

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


class _ConvNd(nn.Module):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None):
        super().__init__()
        if weight_attr is False:
            raise ValueError("a convolution needs a weight")
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: only 'zeros' is ported")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = list(_tuplify(kernel_size, n))
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self.weight = make_param(
            [out_channels, in_channels // groups] + self._kernel_size,
            weight_attr, XavierUniform(), device=device)
        self.bias = make_param([out_channels], bias_attr, is_bias=True,
                               device=device)

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device)


class Conv2D(_ConvNd):
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device)


class Conv3D(_ConvNd):
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device)
