"""``paddle.dataset.wmt14`` (reference: dataset/wmt14.py) — readers
yielding (src ids, trg ids, trg_next ids)."""
from __future__ import annotations


def _reader(mode, dict_size, data_file=None):
    def reader():
        from paddle_tpu_torch.text.datasets import WMT14
        ds = WMT14(data_file=data_file, mode=mode, dict_size=dict_size)
        for sample in ds:
            yield tuple(sample)

    return reader


def train(dict_size, data_file=None):
    return _reader("train", dict_size, data_file)


def test(dict_size, data_file=None):
    return _reader("test", dict_size, data_file)
