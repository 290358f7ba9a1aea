"""``paddle.dataset.cifar`` (reference: dataset/cifar.py) — readers
yielding (3072-float32 in [0, 1] CHW-flattened, int label)."""
from __future__ import annotations

import numpy as np


def _reader(cls_name, mode, data_file=None):
    def reader():
        import paddle_tpu_torch.vision.datasets as D
        ds = getattr(D, cls_name)(data_file=data_file, mode=mode)
        for img, lab in ds:
            chw = np.asarray(img, np.float32)
            if chw.ndim == 3 and chw.shape[-1] == 3:   # HWC → CHW
                chw = chw.transpose(2, 0, 1)
            yield chw.reshape(-1) / 255.0, int(lab)

    return reader


def train10(data_file=None):
    return _reader("Cifar10", "train", data_file)


def test10(data_file=None):
    return _reader("Cifar10", "test", data_file)


def train100(data_file=None):
    return _reader("Cifar100", "train", data_file)


def test100(data_file=None):
    return _reader("Cifar100", "test", data_file)
