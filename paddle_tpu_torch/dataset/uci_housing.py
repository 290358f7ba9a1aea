"""``paddle.dataset.uci_housing`` (reference: dataset/uci_housing.py) —
readers yielding (13-float32 features, (1,)-float32 price)."""
from __future__ import annotations

import numpy as np


def _reader(mode, data_file=None):
    def reader():
        from paddle_tpu_torch.text.datasets import UCIHousing
        ds = UCIHousing(data_file=data_file, mode=mode)
        for x, y in ds:
            yield np.asarray(x, np.float32), np.asarray(y, np.float32)

    return reader


def train(data_file=None):
    return _reader("train", data_file)


def test(data_file=None):
    return _reader("test", data_file)
