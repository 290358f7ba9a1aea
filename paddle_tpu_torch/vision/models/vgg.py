"""VGG (port of paddle_tpu/vision/models/vgg.py): ``VGG`` and ``vgg11``,
``vgg13``, ``vgg16``, ``vgg19``, with and without BatchNorm, with the
reference's module and parameter names (``features.0``,
``classifier.6``), so weights carry across by name.  Parameters are
created on the card unless ``device="cpu"``; the head's dropouts draw
from ``generator``.  ``pretrained=True`` raises: nothing is downloaded.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.vision.models.mobilenet import _no_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False, device=None):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(nn.Conv2D(in_channels, v, kernel_size=3, padding=1,
                                    device=device))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, device=device))
            layers.append(nn.ReLU())
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """``features``, then a 7x7 adaptive average pool and the
    4096-4096-``num_classes`` head with ReLUs and dropouts."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, device=device),
                nn.ReLU(),
                nn.Dropout(generator=generator),
                nn.Linear(4096, 4096, device=device),
                nn.ReLU(),
                nn.Dropout(generator=generator),
                nn.Linear(4096, num_classes, device=device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, device=None, **kwargs):
    _no_pretrained(pretrained)
    return VGG(_make_layers(_CFGS[cfg], batch_norm, device), device=device,
               **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
