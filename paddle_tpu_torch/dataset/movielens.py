"""``paddle.dataset.movielens`` (reference: dataset/movielens.py) —
readers yielding the reference's 8-field rating tuples."""
from __future__ import annotations


def _reader(mode, data_file=None):
    def reader():
        from paddle_tpu_torch.text.datasets import Movielens
        ds = Movielens(data_file=data_file, mode=mode)
        for sample in ds:
            yield tuple(sample)

    return reader


def train(data_file=None):
    return _reader("train", data_file)


def test(data_file=None):
    return _reader("test", data_file)


def max_user_id(data_file=None):
    from paddle_tpu_torch.text.datasets import Movielens
    return int(max(s[0] for s in Movielens(data_file=data_file,
                                           mode="train")))


def max_movie_id(data_file=None):
    from paddle_tpu_torch.text.datasets import Movielens
    return int(max(s[4] for s in Movielens(data_file=data_file,
                                           mode="train")))
