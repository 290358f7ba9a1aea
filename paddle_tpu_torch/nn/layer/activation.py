"""Activation layers (port of paddle_tpu/nn/layer/activation.py): each
calls its functional with the reference's defaults; ``PReLU`` holds its
weight (``init`` 0.25, one or ``num_parameters``), created on the card
unless ``device="cpu"``."""
from __future__ import annotations


from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import Constant
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid",
           "Hardsigmoid", "Hardswish", "Hardtanh", "Hardshrink", "Softshrink",
           "Tanhshrink", "LeakyReLU", "PReLU", "LogSigmoid", "Maxout", "Silu",
           "Swish", "Mish", "Softmax", "LogSoftmax", "Softplus", "Softsign",
           "Tanh", "ThresholdedReLU", "GLU"]


def _simple(fname, cls_name, **defaults):
    """A layer that calls ``F.<fname>`` with its keyword arguments (the
    reference's ``_simple`` :15)."""
    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            self._kwargs = {**defaults, **{k: v for k, v in kwargs.items()
                                           if k != "name"}}

        def forward(self, x):
            return getattr(F, fname)(x, **self._kwargs)
    _Act.__name__ = cls_name
    _Act.__qualname__ = cls_name
    return _Act


ReLU = _simple("relu", "ReLU")
ReLU6 = _simple("relu6", "ReLU6")
Sigmoid = _simple("sigmoid", "Sigmoid")
Hardswish = _simple("hardswish", "Hardswish")
Tanhshrink = _simple("tanhshrink", "Tanhshrink")
LogSigmoid = _simple("log_sigmoid", "LogSigmoid")
Silu = _simple("silu", "Silu")
Swish = _simple("swish", "Swish")
Mish = _simple("mish", "Mish")
Softsign = _simple("softsign", "Softsign")
Tanh = _simple("tanh", "Tanh")


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None):
        super().__init__()
        from paddle_tpu_torch.nn.layer.common import make_param
        self._data_format = data_format
        self.weight = make_param([num_parameters], weight_attr,
                                 Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)
