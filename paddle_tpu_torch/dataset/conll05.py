"""``paddle.dataset.conll05`` (reference: dataset/conll05.py) — SRL
test reader (the reference also only ships the test split publicly)."""
from __future__ import annotations


def test(data_file=None, **kw):
    def reader():
        from paddle_tpu_torch.text.datasets import Conll05st
        ds = Conll05st(data_file=data_file, **kw)
        for sample in ds:
            yield tuple(sample)

    return reader


def get_dict(data_file=None, **kw):
    from paddle_tpu_torch.text.datasets import Conll05st
    ds = Conll05st(data_file=data_file, **kw)
    return ds.word_dict, ds.predicate_dict, ds.label_dict
