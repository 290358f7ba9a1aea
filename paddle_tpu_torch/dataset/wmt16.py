"""``paddle.dataset.wmt16`` (reference: dataset/wmt16.py)."""
from __future__ import annotations


def _reader(mode, src_dict_size, trg_dict_size, src_lang, data_file=None):
    def reader():
        from paddle_tpu_torch.text.datasets import WMT16
        ds = WMT16(data_file=data_file, mode=mode,
                   src_dict_size=src_dict_size,
                   trg_dict_size=trg_dict_size, lang=src_lang)
        for sample in ds:
            yield tuple(sample)

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en", data_file=None):
    return _reader("train", src_dict_size, trg_dict_size, src_lang,
                   data_file)


def test(src_dict_size, trg_dict_size, src_lang="en", data_file=None):
    return _reader("test", src_dict_size, trg_dict_size, src_lang,
                   data_file)


def validation(src_dict_size, trg_dict_size, src_lang="en",
               data_file=None):
    return _reader("val", src_dict_size, trg_dict_size, src_lang,
                   data_file)
