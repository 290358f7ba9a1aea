"""``Conv1D``, ``Conv2D``, ``Conv3D`` and their transposes
``Conv{1,2,3}DTranspose`` (port of paddle_tpu/nn/layer/conv.py
``_ConvNd`` :23-147).

The weight is (out, in / groups) + kernel ((in, out / groups) + kernel
for a transposed convolution), drawn Xavier-uniform with
``fan_in = in / groups * prod(kernel)`` and ``fan_out = out *
prod(kernel)`` (reference nn/initializer/__init__.py:39-51), the bias is
zero (``bias_attr=False``: none); a ``ParamAttr`` or an initializer
overrides either (``nn.layer.common.make_param``).  Parameters are created
on the card unless ``device="cpu"``.  Only ``padding_mode="zeros"`` is
ported.  A transposed layer's ``forward(x, output_size=None)`` passes
``output_size`` on (``F.conv2d_transpose``).
"""
from __future__ import annotations


from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.conv import _tuplify
from paddle_tpu_torch.nn.initializer import XavierUniform
from paddle_tpu_torch.nn.layer.common import make_param
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, transpose=False, output_padding=0):
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
        self._output_padding = output_padding
        shape = ([in_channels, out_channels // groups] if transpose else
                 [out_channels, in_channels // groups]) + self._kernel_size
        self.weight = make_param(shape, weight_attr, XavierUniform(),
                                 device=device)
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


class _ConvTransposeNd(_ConvNd):
    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._output_padding, self._groups,
                        self._dilation, output_size, self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, device, True, output_padding)


class Conv2DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, device, True, output_padding)


class Conv3DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, device, True, output_padding)
