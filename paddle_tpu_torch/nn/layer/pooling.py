"""The pooling layers, ``{Max,Avg}Pool{1,2,3}D`` and
``Adaptive{Avg,Max}Pool{1,2,3}D`` (port of paddle_tpu/nn/layer/pooling.py
:13-138).  As in the reference, a keyword the functional does not honour
raises instead of being dropped."""
from __future__ import annotations


from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


def _check_kwargs(layer, kwargs):
    unsupported = set(kwargs) - set(layer._allowed)
    if unsupported:
        raise ValueError(f"{type(layer).__name__} does not support kwargs "
                         f"{sorted(unsupported)}")
    return {k: v for k, v in kwargs.items() if k != "name"}


class _PoolNd(Layer):
    _fn = None
    _allowed = ("name",)

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kwargs = _check_kwargs(self, kwargs)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        **self.kwargs)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class AvgPool1D(_PoolNd):
    _fn = staticmethod(F.avg_pool1d)
    _allowed = ("exclusive", "ceil_mode", "data_format", "name")


class AvgPool2D(_PoolNd):
    _fn = staticmethod(F.avg_pool2d)
    _allowed = ("exclusive", "ceil_mode", "divisor_override", "data_format",
                "name")


class AvgPool3D(_PoolNd):
    _fn = staticmethod(F.avg_pool3d)
    _allowed = AvgPool2D._allowed


class MaxPool1D(_PoolNd):
    _fn = staticmethod(F.max_pool1d)
    _allowed = ("return_mask", "ceil_mode", "data_format", "name")


class MaxPool2D(_PoolNd):
    _fn = staticmethod(F.max_pool2d)
    _allowed = MaxPool1D._allowed


class MaxPool3D(_PoolNd):
    _fn = staticmethod(F.max_pool3d)
    _allowed = MaxPool1D._allowed


class _AdaptivePool(Layer):
    _fn = None
    _allowed = ("name",)

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.kwargs = _check_kwargs(self, kwargs)
        self.output_size = output_size

    def forward(self, x):
        return self._fn(x, self.output_size, **self.kwargs)

    def extra_repr(self):
        return f"output_size={self.output_size}"


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool2d)
    _allowed = ("data_format", "name")


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool3d)
    _allowed = ("data_format", "name")


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool1d)
    _allowed = ("return_mask", "name")


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool2d)
    _allowed = ("return_mask", "name")


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool3d)
    _allowed = ("return_mask", "name")
