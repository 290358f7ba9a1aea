"""The port's datasets and readers (paddle_tpu_torch/vision/datasets,
text/datasets.py, dataset/, reader.py) against the reference's on the
CPU.

Small files in the reference formats (MNIST's idx, CIFAR's pickles, IMDB,
PTB, UCI housing, MovieLens, WMT14/16, CoNLL-05, Flowers, VOC2012, a
JPEG class folder) go through both packages; every sample must be equal,
values and dtypes.  The 1.x reader creators (``dataset.*``) and the
``reader`` combinators are compared the same way.  Absent files raise,
and ``dataset.common.download`` resolves only a cached file.
"""
import gzip
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import dataset as jdataset
from paddle_tpu import reader as jreader
from paddle_tpu.text import datasets as jtext
from paddle_tpu.vision import datasets as jvision
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import dataset as tdataset
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.text import datasets as ttext
from paddle_tpu_torch.vision import datasets as tvision

from test_datasets_extra import (_conll_tgz, _flowers_files, _jpg_bytes,
                                 _movielens_zip, _tar_add, _voc_tar,
                                 _wmt14_tgz, _wmt16_tgz)


def _same(a, b):
    if isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, (np.ndarray, np.generic)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    else:
        assert a == b


def _same_dataset(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        _same(got[i], want[i])


def _mnist(tmp, n=8):
    rng = np.random.default_rng(0)
    ip, lp = os.path.join(tmp, "imgs.gz"), os.path.join(tmp, "labs.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(rng.integers(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(rng.integers(0, 10, (n,), dtype=np.uint8).tobytes())
    return ip, lp


def _cifar(tmp, name="cifar-10-python.tar.gz", key=b"labels"):
    rng = np.random.default_rng(1)
    path = os.path.join(tmp, name)
    members = ((("data_batch_1", 3), ("data_batch_2", 2), ("test_batch", 2))
               if key == b"labels" else (("train", 3), ("test", 2)))
    with tarfile.open(path, "w:gz") as tf:
        for member, n in members:
            d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 key: [int(v) for v in rng.integers(0, 10, n)]}
            _tar_add(tf, f"cifar/{member}", pickle.dumps(d))
    return path


def _imdb(tmp):
    path = os.path.join(tmp, "imdb.tar.gz")
    docs = {"train/pos/0.txt": b"a good good film", "train/neg/1.txt":
            b"a bad film, bad!", "test/pos/2.txt": b"good film",
            "test/neg/3.txt": b"bad bad"}
    with tarfile.open(path, "w:gz") as tf:
        for name, text in docs.items():
            _tar_add(tf, "aclImdb/" + name, text)
    return path


def _ptb(tmp):
    path = os.path.join(tmp, "simple-examples.tgz")
    with tarfile.open(path, "w:gz") as tf:
        _tar_add(tf, "./simple-examples/data/ptb.train.txt",
                 b"the cat sat on the mat\nthe dog sat\n")
        _tar_add(tf, "./simple-examples/data/ptb.valid.txt",
                 b"the cat ran\n")
    return path


def _housing(tmp):
    rng = np.random.default_rng(2)
    path = os.path.join(tmp, "housing.data")
    np.savetxt(path, np.concatenate([rng.standard_normal((20, 13)),
                                     rng.uniform(5, 50, (20, 1))], axis=1))
    return path


def test_vision_datasets_match_reference(tmp_path):
    """MNIST, FashionMNIST, Cifar10/100, Flowers, VOC2012, FakeData: the
    reference's samples, equal in values and dtypes."""
    d = str(tmp_path)
    ip, lp = _mnist(d)
    for cls in ("MNIST", "FashionMNIST"):
        _same_dataset(getattr(tvision, cls)(image_path=ip, label_path=lp),
                      getattr(jvision, cls)(image_path=ip, label_path=lp))
    c10 = _cifar(d)
    c100 = _cifar(d, "cifar-100-python.tar.gz", b"fine_labels")
    for mode in ("train", "test"):
        _same_dataset(tvision.Cifar10(data_file=c10, mode=mode),
                      jvision.Cifar10(data_file=c10, mode=mode))
        _same_dataset(tvision.Cifar100(data_file=c100, mode=mode),
                      jvision.Cifar100(data_file=c100, mode=mode))
    tgz, labels, setid = _flowers_files(d)
    for mode in ("train", "valid", "test"):
        kw = dict(data_file=tgz, label_file=labels, setid_file=setid,
                  mode=mode)
        _same_dataset(tvision.Flowers(**kw), jvision.Flowers(**kw))
    voc = os.path.join(d, "voc.tar")
    _voc_tar(voc)
    for mode in ("train", "valid"):
        _same_dataset(tvision.VOC2012(data_file=voc, mode=mode),
                      jvision.VOC2012(data_file=voc, mode=mode))
    _same_dataset(tvision.FakeData(6, (3, 4, 4), seed=3),
                  jvision.FakeData(6, (3, 4, 4), seed=3))


def test_folders_match_reference(tmp_path):
    """DatasetFolder over a two-class JPEG tree (PIL loader) and over
    .npy files, ImageFolder over a flat folder."""
    from PIL import Image
    rng = np.random.default_rng(4)
    for c in range(2):
        os.makedirs(tmp_path / "jpg" / f"class_{c}")
        os.makedirs(tmp_path / "npy" / f"class_{c}")
        for i in range(3):
            arr = rng.integers(0, 256, (10, 10, 3), dtype=np.uint8)
            open(tmp_path / "jpg" / f"class_{c}" / f"{i}.jpg", "wb").write(
                _jpg_bytes(arr))
            np.save(tmp_path / "npy" / f"class_{c}" / f"{i}.npy", arr)

    def pil(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    kw = dict(loader=pil, extensions=(".jpg",))
    got = tvision.DatasetFolder(str(tmp_path / "jpg"), **kw)
    want = jvision.DatasetFolder(str(tmp_path / "jpg"), **kw)
    assert got.classes == want.classes and len(got) == 6
    _same_dataset(got, want)
    _same_dataset(tvision.DatasetFolder(str(tmp_path / "npy")),
                  jvision.DatasetFolder(str(tmp_path / "npy")))
    flat = str(tmp_path / "npy" / "class_0")
    _same_dataset(tvision.ImageFolder(flat), jvision.ImageFolder(flat))


def test_text_datasets_match_reference(tmp_path):
    """Imdb, Imikolov (NGRAM and SEQ), UCIHousing, Movielens, WMT14,
    WMT16, Conll05st, FakeTextDataset: the reference's samples and
    dictionaries."""
    d = str(tmp_path)
    imdb = _imdb(d)
    for mode in ("train", "test"):
        got, want = (m.Imdb(data_file=imdb, mode=mode, cutoff=0)
                     for m in (ttext, jtext))
        _same_dataset(got, want)
        assert got.word_idx == want.word_idx
    ptb = _ptb(d)
    for kw in (dict(data_type="NGRAM", window_size=3, min_word_freq=0),
               dict(data_type="SEQ", min_word_freq=0, mode="test")):
        _same_dataset(ttext.Imikolov(data_file=ptb, **kw),
                      jtext.Imikolov(data_file=ptb, **kw))
    housing = _housing(d)
    for mode in ("train", "test"):
        _same_dataset(ttext.UCIHousing(data_file=housing, mode=mode),
                      jtext.UCIHousing(data_file=housing, mode=mode))
    ml = os.path.join(d, "ml-1m.zip")
    _movielens_zip(ml)
    for mode in ("train", "test"):
        _same_dataset(ttext.Movielens(data_file=ml, mode=mode),
                      jtext.Movielens(data_file=ml, mode=mode))
    w14, w16, conll = (os.path.join(d, n) for n in
                       ("wmt14.tgz", "wmt16.tgz", "conll.tgz"))
    _wmt14_tgz(w14)
    _wmt16_tgz(w16)
    _conll_tgz(conll)
    for mode in ("train", "test"):
        _same_dataset(ttext.WMT14(data_file=w14, mode=mode),
                      jtext.WMT14(data_file=w14, mode=mode))
    for mode, lang in (("train", "en"), ("val", "en"), ("train", "de")):
        got = ttext.WMT16(data_file=w16, mode=mode, lang=lang)
        want = jtext.WMT16(data_file=w16, mode=mode, lang=lang)
        _same_dataset(got, want)
        assert got.src_dict == want.src_dict
    got, want = (m.Conll05st(data_file=conll) for m in (ttext, jtext))
    _same_dataset(got, want)
    assert got.get_dict() == want.get_dict()
    _same_dataset(ttext.FakeTextDataset(), jtext.FakeTextDataset())


def test_missing_files_raise_without_fetching(tmp_path):
    """An absent file raises RuntimeError naming it, in both packages;
    dataset.common.download resolves a cached file and raises for an
    absent one."""
    for mod in (tvision, jvision):
        with pytest.raises(RuntimeError, match="not found"):
            mod.MNIST(image_path=str(tmp_path / "no.gz"),
                      label_path=str(tmp_path / "no2.gz"))
    with pytest.raises(RuntimeError, match="not found"):
        ttext.Imdb(data_file=str(tmp_path / "none.tgz"))
    common = tdataset.common
    url = "https://example.invalid/files/data.bin"
    with pytest.raises(RuntimeError, match="does not download"):
        common.download(url, "mod", None)
    old = common.DATA_HOME
    common.DATA_HOME = str(tmp_path)
    try:
        os.makedirs(tmp_path / "mod")
        (tmp_path / "mod" / "data.bin").write_bytes(b"abc")
        md5 = common.md5file(str(tmp_path / "mod" / "data.bin"))
        assert common.download(url, "mod", md5) == str(
            tmp_path / "mod" / "data.bin")
        with pytest.raises(IOError, match="md5"):
            common.download(url, "mod", "0" * 32)
    finally:
        common.DATA_HOME = old


def test_reader_creators_match_reference(tmp_path):
    """The 1.x readers (mnist, cifar, imdb, imikolov, uci_housing,
    movielens, flowers, voc2012, wmt14, wmt16, conll05) yield the
    reference's samples; paddle.batch batches them alike."""
    d = str(tmp_path)
    ip, lp = _mnist(d)
    c10 = _cifar(d)
    imdb, ptb, housing = _imdb(d), _ptb(d), _housing(d)
    ml = os.path.join(d, "ml-1m.zip")
    _movielens_zip(ml)
    tgz, labels, setid = _flowers_files(d)
    voc, w14, w16, conll = (os.path.join(d, n) for n in (
        "voc.tar", "wmt14.tgz", "wmt16.tgz", "conll.tgz"))
    _voc_tar(voc)
    _wmt14_tgz(w14)
    _wmt16_tgz(w16)
    _conll_tgz(conll)

    def creators(ds):
        wi = ds.imdb.word_dict(data_file=imdb, cutoff=0)
        pi = ds.imikolov.build_dict(min_word_freq=0, data_file=ptb)
        return [
            ds.mnist.train(image_path=ip, label_path=lp),
            ds.cifar.train10(data_file=c10), ds.cifar.test10(data_file=c10),
            ds.imdb.train(wi, data_file=imdb),
            ds.imikolov.train(pi, 3, data_file=ptb),
            ds.uci_housing.train(data_file=housing),
            ds.movielens.train(data_file=ml),
            ds.flowers.train(data_file=tgz, label_file=labels,
                             setid_file=setid),
            ds.voc2012.train(data_file=voc),
            ds.wmt14.train(5, data_file=w14),
            ds.wmt16.train(5, 5, data_file=w16),
            ds.conll05.test(data_file=conll)]
    for got, want in zip(creators(tdataset), creators(jdataset)):
        _same(list(got()), list(want()))
    _same(list(tpaddle.batch(tdataset.uci_housing.train(
        data_file=housing), 3)()), list(paddle.batch(
            jdataset.uci_housing.train(data_file=housing), 3)()))


def test_reader_combinators_match_reference():
    """reader.py: map_readers, shuffle (seeded random), chain, compose,
    buffered, firstn, xmap_readers (ordered), cache, batch."""
    import random

    def r(n, k=1):
        return lambda: iter(range(0, n * k, k))

    def run(rd):
        random.seed(5)
        return [
            list(rd.map_readers(lambda a, b: a + b, r(5), r(5, 2))()),
            list(rd.shuffle(r(12), 4)()),
            list(rd.chain(r(3), r(2))()),
            list(rd.compose(r(3), r(3, 3))()),
            list(rd.buffered(r(7), 2)()),
            list(rd.firstn(r(9), 4)()),
            list(rd.xmap_readers(lambda v: v * v, r(8), 2, 4,
                                 order=True)()),
            list(rd.cache(r(4))()),
            list(rd.batch(r(7), 3, drop_last=True)()),
            list(rd.batch(r(7), 3)())]
    assert run(treader) == run(jreader)
    with pytest.raises(treader.ComposeNotAligned):
        list(treader.compose(r(3), r(4))())
