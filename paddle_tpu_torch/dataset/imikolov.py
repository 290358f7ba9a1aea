"""``paddle.dataset.imikolov`` (reference: dataset/imikolov.py) — PTB
n-gram readers yielding window_size-tuples of word ids.  The readers
tokenize with the ``word_idx`` the caller passes (the 1.x contract), so
a dict built with a non-default ``min_word_freq`` stays consistent with
the ids the reader yields."""
from __future__ import annotations


def build_dict(min_word_freq=50, data_file=None):
    from paddle_tpu_torch.text.datasets import Imikolov
    return Imikolov(data_file=data_file, mode="train",
                    min_word_freq=min_word_freq).word_idx


def _reader(mode, word_idx, n, data_file=None):
    def reader():
        from paddle_tpu_torch.text.datasets import Imikolov
        ds = Imikolov(data_file=data_file, mode=mode, data_type="NGRAM",
                      window_size=n, word_idx=word_idx)
        for gram in ds:
            yield tuple(int(v) for v in gram)

    return reader


def train(word_idx, n, data_file=None):
    return _reader("train", word_idx, n, data_file)


def test(word_idx, n, data_file=None):
    return _reader("test", word_idx, n, data_file)
