"""MobileNetV1 and MobileNetV2 (port of
paddle_tpu/vision/models/mobilenet.py), with the reference's module and
parameter names (``conv1.conv``, ``blocks.0.dw.bn``, ``features.1.conv.0``,
``classifier.1``), so weights and BatchNorm buffers carry across by name
(``models.load_named_params`` / ``load_named_buffers``).

Convolutions have no bias, each is followed by a BatchNorm and a ReLU
(ReLU6 in V2); V2's inverted residuals add their input where the stride
is 1 and the widths match; V2's head is a Dropout(0.2) and a Linear.
Parameters and buffers are created on the card unless ``device="cpu"``;
the head's dropout draws from ``generator``.  ``pretrained=True``
raises: nothing is downloaded.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch import nn

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class _ConvBNRelu(nn.Layer):
    def __init__(self, in_c, out_c, kernel=3, stride=1, padding=0,
                 groups=1, relu6=False, device=None):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False, device=device)
        self.bn = nn.BatchNorm2D(out_c, device=device)
        self.act = nn.ReLU6() if relu6 else nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, stride, scale, device=None):
        super().__init__()
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = _ConvBNRelu(in_c, c1, 3, stride=stride, padding=1,
                              groups=in_c, device=device)
        self.pw = _ConvBNRelu(c1, c2, 1, device=device)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)
        self.conv1 = _ConvBNRelu(3, s(32), 3, stride=2, padding=1,
                                 device=device)
        cfg = [  # in, out1, out2, stride
            (s(32), 32, 64, 1), (s(64), 64, 128, 2), (s(128), 128, 128, 1),
            (s(128), 128, 256, 2), (s(256), 256, 256, 1),
            (s(256), 256, 512, 2)] + [(s(512), 512, 512, 1)] * 5 + [
            (s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1)]
        self.blocks = nn.Sequential(*[
            _DepthwiseSeparable(i, o1, o2, st, scale, device=device)
            for i, o1, o2, st in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes, device=device)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio, device=None):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNRelu(inp, hidden, 1, relu6=True,
                                      device=device))
        layers.extend([
            _ConvBNRelu(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, relu6=True, device=device),
            nn.Conv2D(hidden, oup, 1, bias_attr=False, device=device),
            nn.BatchNorm2D(oup, device=device)])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = int(32 * scale)
        last_c = int(1280 * max(1.0, scale))
        features = [_ConvBNRelu(3, in_c, 3, stride=2, padding=1, relu6=True,
                                device=device)]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(_InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t, device=device))
                in_c = out_c
        features.append(_ConvBNRelu(in_c, last_c, 1, relu6=True,
                                    device=device))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2, generator=generator),
                nn.Linear(last_c, num_classes, device=device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError(
            "pretrained=True unavailable (nothing is downloaded); load "
            "weights with models.load_named_params / load_named_buffers")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
