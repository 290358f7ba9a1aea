"""``paddle.dataset.imdb`` (reference: dataset/imdb.py) — readers
yielding (word-id list, 0/1 label); 0 = positive, like the reference.
``train(word_idx)``/``test(word_idx)`` tokenize with the supplied dict
(the 1.x contract), so a dict built with a non-default cutoff stays
consistent with the ids the reader yields."""
from __future__ import annotations


def word_dict(data_file=None, cutoff=150):
    from paddle_tpu_torch.text.datasets import Imdb
    return Imdb(data_file=data_file, mode="train", cutoff=cutoff).word_idx


def _reader(mode, word_idx=None, data_file=None):
    def reader():
        from paddle_tpu_torch.text.datasets import Imdb
        ds = Imdb(data_file=data_file, mode=mode, word_idx=word_idx)
        for ids, lab in ds:
            yield list(ids), int(lab)

    return reader


def train(word_idx=None, data_file=None):
    return _reader("train", word_idx, data_file)


def test(word_idx=None, data_file=None):
    return _reader("test", word_idx, data_file)
