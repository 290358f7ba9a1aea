"""``paddle.dataset.mnist`` (reference: dataset/mnist.py) — readers
yielding the 1.x sample format: (784-float32 in [-1, 1], int label)."""
from __future__ import annotations

import numpy as np


def _reader(mode, image_path=None, label_path=None):
    def reader():
        from paddle_tpu_torch.vision.datasets import MNIST
        ds = MNIST(image_path=image_path, label_path=label_path, mode=mode)
        for img, lab in ds:
            arr = np.asarray(img, np.float32).reshape(-1)
            yield arr / 127.5 - 1.0, int(lab)

    return reader


def train(image_path=None, label_path=None):
    return _reader("train", image_path, label_path)


def test(image_path=None, label_path=None):
    return _reader("test", image_path, label_path)
