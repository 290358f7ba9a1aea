"""paddle_tpu_torch.text (port of paddle_tpu/text; parity:
python/paddle/text/ — datasets Imdb, Imikolov, Movielens, UCIHousing,
WMT14/16, Conll05st)."""
from paddle_tpu_torch.text import datasets  # noqa: F401
from paddle_tpu_torch.text.datasets import (  # noqa: F401
    Conll05st, Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16,
    FakeTextDataset)

__all__ = ["Imdb", "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16",
           "Conll05st", "FakeTextDataset"]
