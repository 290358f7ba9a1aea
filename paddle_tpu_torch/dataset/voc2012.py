"""``paddle.dataset.voc2012`` (reference: dataset/voc2012.py) — readers
yielding (image CHW float32, segmentation-mask HW int64)."""
from __future__ import annotations

import numpy as np


def _reader(mode, data_file=None):
    def reader():
        from paddle_tpu_torch.vision.datasets import VOC2012
        ds = VOC2012(data_file=data_file, mode=mode)
        for img, mask in ds:
            arr = np.asarray(img, np.float32)
            if arr.ndim == 3 and arr.shape[-1] == 3:
                arr = arr.transpose(2, 0, 1)
            yield arr, np.asarray(mask, np.int64)

    return reader


def train(data_file=None):
    return _reader("train", data_file)


def test(data_file=None):
    return _reader("test", data_file)


def val(data_file=None):
    return _reader("valid", data_file)
