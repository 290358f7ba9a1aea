"""``paddle.dataset`` — the 1.x reader-creator surface (reference:
python/paddle/dataset/{mnist,cifar,imdb,imikolov,uci_housing,movielens,
flowers,voc2012,wmt14,wmt16,conll05,common}.py).

1.x scripts consume datasets as reader creators —
``paddle.batch(paddle.dataset.mnist.train(), 128)`` — functions that
return a generator of samples.  Each module here is a thin reader layer
over the 2.x Dataset classes (vision.datasets / text.datasets), with
the 1.x sample formats (flattened/normalized arrays).  Files are local
(the port never downloads); missing files raise the same
guided error the 2.x classes raise.
"""
from paddle_tpu_torch.dataset import (cifar, common, conll05, flowers, imdb,
                                imikolov, mnist, movielens, uci_housing,
                                voc2012, wmt14, wmt16)

__all__ = ["mnist", "cifar", "imdb", "imikolov", "uci_housing",
           "movielens", "flowers", "voc2012", "wmt14", "wmt16",
           "conll05", "common"]
