"""Image transforms (port of paddle_tpu/vision/transforms/__init__.py).

Host-side: images are HWC numpy arrays (uint8 or float) and stay numpy
through the per-sample pipeline; the move to the card belongs to the
batch (a loader's collate), one transfer a batch.  ``to_tensor`` /
``ToTensor`` return a float32 numpy array in [0, 1] by default and a CPU
``torch.Tensor`` with ``out="tensor"``; ``normalize`` returns what it was
given.  A ``torch.Tensor`` input is read as a numpy array.

``resize`` takes two routes, as the reference: a uint8 image of 1, 3 or 4
channels resized ``bilinear`` or ``nearest`` goes through PIL's
``Image.resize`` when PIL imports (``resize_route`` says which), and
everything else through the numpy bilinear / nearest below.

The random transforms draw from ``generator``, a ``random.Random``; when
None, from Python's global ``random``, which the reference draws from.
So a reference seeded by ``random.seed(s)`` and a port given
``random.Random(s)`` make the same draws in the same order.
"""
from __future__ import annotations

import numbers
import random
from typing import List, Sequence

import numpy as np
import torch

__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
           "RandomHorizontalFlip", "RandomVerticalFlip", "RandomCrop",
           "CenterCrop", "RandomResizedCrop", "Pad", "Transpose",
           "BrightnessTransform", "ContrastTransform", "SaturationTransform",
           "HueTransform", "ColorJitter", "Grayscale", "RandomRotation",
           "to_tensor", "normalize", "resize", "hflip", "vflip", "crop",
           "center_crop", "pad", "resize_route"]


def _as_hwc(img):
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def _pil_image():
    """PIL's ``Image`` module, or None when PIL does not import."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def resize_route() -> str:
    """``"PIL"`` if ``resize`` sends uint8 images through PIL here, else
    ``"numpy"``."""
    return "PIL" if _pil_image() is not None else "numpy"


# -- functional -------------------------------------------------------------


def to_tensor(img, data_format="CHW", out="numpy"):
    """HWC image -> float32 in [0, 1] (uint8 divided by 255), CHW by
    default: a numpy array, or a CPU tensor with ``out="tensor"``."""
    img = _as_hwc(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if data_format == "CHW":
        img = img.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(img)) if out == "tensor" \
        else img


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    is_tensor = isinstance(img, torch.Tensor)
    arr = img.detach().cpu().numpy() if is_tensor else np.asarray(
        img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        arr = (arr - mean[:, None, None]) / std[:, None, None]
    else:
        arr = (arr - mean) / std
    return torch.from_numpy(arr) if is_tensor else arr


def resize(img, size, interpolation="bilinear"):
    """An HWC image resized to ``size`` (h, w), or its shorter side to an
    int ``size`` keeping the aspect ratio."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h <= w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    if (oh, ow) == (h, w):
        return img
    if img.dtype == np.uint8 and img.shape[-1] in (1, 3, 4) and \
            interpolation in ("bilinear", "nearest"):
        image = _pil_image()
        if image is not None:
            pim = image.fromarray(img[:, :, 0] if img.shape[-1] == 1
                                  else img)
            out = np.asarray(pim.resize((ow, oh), image.BILINEAR if
                                        interpolation == "bilinear"
                                        else image.NEAREST))
            return out[:, :, None] if img.shape[-1] == 1 else out
    if interpolation == "nearest":
        ri = (np.arange(oh) * h / oh).astype(int).clip(0, h - 1)
        ci = (np.arange(ow) * w / ow).astype(int).clip(0, w - 1)
        return img[ri][:, ci]
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.floor(ys).astype(int).clip(0, h - 1)
    x0 = np.floor(xs).astype(int).clip(0, w - 1)
    y1 = (y0 + 1).clip(0, h - 1)
    x1 = (x0 + 1).clip(0, w - 1)
    wy = (ys - y0).clip(0, 1)[:, None, None]
    wx = (xs - x0).clip(0, 1)[None, :, None]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def crop(img, top, left, height, width):
    return _as_hwc(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    img = _as_hwc(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = img.shape[:2]
    th, tw = output_size
    return crop(img, max(0, (h - th) // 2), max(0, (w - tw) // 2), th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    """``padding`` an int, (left/right, top/bottom) or (left, top, right,
    bottom); ``constant``, ``edge``, ``reflect`` or ``symmetric``."""
    img = _as_hwc(img)
    if isinstance(padding, int):
        padding = (padding,) * 4
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    if padding_mode not in ("constant", "edge", "reflect", "symmetric"):
        raise KeyError(padding_mode)
    kwargs = {"constant_values": fill} if padding_mode == "constant" else {}
    return np.pad(img, ((top, bottom), (left, right), (0, 0)),
                  mode=padding_mode, **kwargs)


# -- transform classes ------------------------------------------------------


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


class _RandomTransform(BaseTransform):
    """A transform that draws from ``generator`` (Python's global
    ``random`` when None)."""

    def __init__(self, keys=None, generator=None):
        super().__init__(keys)
        self.generator = generator if generator is not None else random


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None, out="numpy"):
        super().__init__(keys)
        self.data_format = data_format
        self.out = out

    def _apply_image(self, img):
        return to_tensor(img, self.data_format, out=self.out)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class RandomHorizontalFlip(_RandomTransform):
    def __init__(self, prob=0.5, keys=None, generator=None):
        super().__init__(keys, generator)
        self.prob = prob

    def _apply_image(self, img):
        return hflip(img) if self.generator.random() < self.prob \
            else _as_hwc(img)


class RandomVerticalFlip(_RandomTransform):
    def __init__(self, prob=0.5, keys=None, generator=None):
        super().__init__(keys, generator)
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if self.generator.random() < self.prob \
            else _as_hwc(img)


class RandomCrop(_RandomTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None, generator=None):
        super().__init__(keys, generator)
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding is not None:
            img = pad(img, self.padding, self.fill, self.padding_mode)
        h, w = img.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            img = pad(img, (0, 0, max(0, tw - w), max(0, th - h)),
                      self.fill, self.padding_mode)
            h, w = img.shape[:2]
        if h < th or w < tw:
            raise ValueError(
                f"RandomCrop: image ({h}x{w}) smaller than crop "
                f"({th}x{tw}); pass pad_if_needed=True")
        top = self.generator.randint(0, max(0, h - th))
        left = self.generator.randint(0, max(0, w - tw))
        return crop(img, top, left, th, tw)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomResizedCrop(_RandomTransform):
    """A crop of random area (``scale`` of the image) and aspect
    (``ratio``), up to 10 tries, else the central square, resized to
    ``size``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None, generator=None):
        super().__init__(keys, generator)
        self.size = (size, size) if isinstance(size, int) else size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        area = h * w
        rng = self.generator
        for _ in range(10):
            target = rng.uniform(*self.scale) * area
            ar = rng.uniform(*self.ratio)
            cw = int(round((target * ar) ** 0.5))
            ch = int(round((target / ar) ** 0.5))
            if 0 < cw <= w and 0 < ch <= h:
                top = rng.randint(0, h - ch)
                left = rng.randint(0, w - cw)
                return resize(crop(img, top, left, ch, cw), self.size,
                              self.interpolation)
        return resize(center_crop(img, min(h, w)), self.size,
                      self.interpolation)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding, self.fill = padding, fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return _as_hwc(img).transpose(self.order)


def _finish_color(orig, out):
    """The input's dtype and range: uint8 stays clipped uint8, a float
    image stays float."""
    if orig.dtype == np.uint8:
        return np.clip(out, 0, 255).astype(np.uint8)
    return out.astype(orig.dtype)


class BrightnessTransform(_RandomTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys, generator)
        self.value = value

    def _apply_image(self, img):
        img = _as_hwc(img)
        f = 1 + self.generator.uniform(-self.value, self.value)
        return _finish_color(img, img.astype(np.float32) * f)


class ContrastTransform(_RandomTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys, generator)
        self.value = value

    def _apply_image(self, img):
        img = _as_hwc(img)
        f = 1 + self.generator.uniform(-self.value, self.value)
        x = img.astype(np.float32)
        mean = x.mean()
        return _finish_color(img, (x - mean) * f + mean)


class SaturationTransform(_RandomTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys, generator)
        self.value = value

    def _apply_image(self, img):
        img = _as_hwc(img)
        f = 1 + self.generator.uniform(-self.value, self.value)
        x = img.astype(np.float32)
        gray = x.mean(axis=2, keepdims=True)
        return _finish_color(img, gray + (x - gray) * f)


class HueTransform(_RandomTransform):
    """The reference's hue approximation: a mix with the channels rolled
    by one."""

    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys, generator)
        self.value = value

    def _apply_image(self, img):
        img = _as_hwc(img)
        f = self.generator.uniform(-self.value, self.value)
        x = img.astype(np.float32)
        rolled = np.roll(x, 1, axis=2)
        return _finish_color(img, x * (1 - abs(f)) + rolled * abs(f))


class ColorJitter(_RandomTransform):
    """Brightness, contrast, saturation and hue in a random order, each
    drawing from the one generator."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None, generator=None):
        super().__init__(keys, generator)
        self.ts: List[BaseTransform] = [
            cls(v, generator=self.generator) for cls, v in (
                (BrightnessTransform, brightness),
                (ContrastTransform, contrast),
                (SaturationTransform, saturation), (HueTransform, hue)) if v]

    def _apply_image(self, img):
        ts = list(self.ts)
        self.generator.shuffle(ts)
        for t in ts:
            img = t(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        img = _as_hwc(img)
        x = img.astype(np.float32)
        if x.shape[2] >= 3:
            g = 0.299 * x[:, :, 0] + 0.587 * x[:, :, 1] + 0.114 * x[:, :, 2]
        else:
            g = x[:, :, 0]
        out = np.repeat(g[:, :, None], self.num_output_channels, axis=2)
        return _finish_color(img, out)


class RandomRotation(_RandomTransform):
    """A random rotation by a multiple of 90 degrees, at most ``degrees``
    (the reference's: below 90 degrees nothing rotates)."""

    def __init__(self, degrees, keys=None, generator=None):
        super().__init__(keys, generator)
        self.degrees = degrees if not isinstance(degrees, (tuple, list)) \
            else max(abs(degrees[0]), abs(degrees[1]))

    def _apply_image(self, img):
        img = _as_hwc(img)
        max_k = min(int(self.degrees // 90), 3)
        k = self.generator.randint(0, max_k) if max_k > 0 else 0
        return np.rot90(img, k, axes=(0, 1)).copy()
