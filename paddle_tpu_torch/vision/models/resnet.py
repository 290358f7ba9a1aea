"""ResNet (port of paddle_tpu/vision/models/resnet.py): ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and ``resnet18`` to ``resnet152``, with the
reference's module and parameter names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``, ``fc``), so weights and
BatchNorm buffers carry across by name.

``data_format`` ("NCHW" or "NHWC") is the layout of every activation; the
weights are OIHW either way.  Parameters and buffers are created on the
card unless ``device="cpu"``.  ``pretrained=True`` raises: nothing is
downloaded.
"""
from __future__ import annotations

import functools

import torch

from paddle_tpu_torch import nn

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=None, data_format="NCHW", device=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(
            nn.BatchNorm2D, data_format=data_format, device=device)
        conv = functools.partial(nn.Conv2D, data_format=data_format,
                                 device=device)
        self.conv1 = conv(inplanes, planes, 3, padding=1, stride=stride,
                          bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = conv(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=None, data_format="NCHW", device=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(
            nn.BatchNorm2D, data_format=data_format, device=device)
        conv = functools.partial(nn.Conv2D, data_format=data_format,
                                 device=device)
        self.conv1 = conv(inplanes, planes, 1, bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.conv2 = conv(planes, planes, 3, padding=1, stride=stride,
                          bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.conv3 = conv(planes, planes * self.expansion, 1,
                          bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """The stem (7x7/2 convolution, BN, ReLU, 3x3/2 max pool), four stages
    of ``block`` and, with ``with_pool``, a global average pool, then a
    ``num_classes`` linear head when ``num_classes > 0``."""

    def __init__(self, block, depth=50, num_classes=1000, with_pool=True,
                 data_format="NCHW", device=None):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        self._device = device
        self._norm_layer = functools.partial(
            nn.BatchNorm2D, data_format=data_format, device=device)
        self._conv = functools.partial(nn.Conv2D, data_format=data_format,
                                       device=device)
        self.inplanes = 64
        self.conv1 = self._conv(3, self.inplanes, 7, stride=2, padding=3,
                                bias_attr=False)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=device)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                self._conv(self.inplanes, planes * block.expansion, 1,
                           stride=stride, bias_attr=False),
                self._norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self._norm_layer, data_format=self.data_format,
                        device=self._device)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes,
                                norm_layer=self._norm_layer,
                                data_format=self.data_format,
                                device=self._device))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained, **kwargs):
    if pretrained:
        raise ValueError(
            "pretrained=True unavailable (nothing is downloaded); load "
            "weights with models.load_named_params / load_named_buffers")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
