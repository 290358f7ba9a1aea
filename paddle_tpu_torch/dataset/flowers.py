"""``paddle.dataset.flowers`` (reference: dataset/flowers.py) — readers
yielding (CHW float32 image, int label)."""
from __future__ import annotations

import numpy as np


def _reader(mode, **kw):
    def reader():
        from paddle_tpu_torch.vision.datasets import Flowers
        ds = Flowers(mode=mode, **kw)
        for img, lab in ds:
            arr = np.asarray(img, np.float32)
            if arr.ndim == 3 and arr.shape[-1] == 3:
                arr = arr.transpose(2, 0, 1)
            yield arr, int(lab)

    return reader


def train(**kw):
    return _reader("train", **kw)


def test(**kw):
    return _reader("test", **kw)


def valid(**kw):
    return _reader("valid", **kw)
