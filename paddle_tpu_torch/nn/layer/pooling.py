"""``MaxPool2D``, ``AvgPool2D`` and ``AdaptiveAvgPool2D`` (port of
paddle_tpu/nn/layer/pooling.py :13-110).  As in the reference, a keyword
the functional does not honour raises instead of being dropped."""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


def _check_kwargs(layer, kwargs):
    unsupported = set(kwargs) - set(layer._allowed)
    if unsupported:
        raise ValueError(f"{type(layer).__name__} does not support kwargs "
                         f"{sorted(unsupported)}")
    return {k: v for k, v in kwargs.items() if k != "name"}


class _PoolNd(nn.Module):
    _allowed = ("name",)

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kwargs = _check_kwargs(self, kwargs)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class AvgPool2D(_PoolNd):
    _allowed = ("exclusive", "ceil_mode", "divisor_override", "data_format",
                "name")

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class MaxPool2D(_PoolNd):
    _allowed = ("return_mask", "ceil_mode", "data_format", "name")

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class AdaptiveAvgPool2D(nn.Module):
    _allowed = ("data_format", "name")

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.kwargs = _check_kwargs(self, kwargs)
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, **self.kwargs)

    def extra_repr(self):
        return f"output_size={self.output_size}"
