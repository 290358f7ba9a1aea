"""Vision datasets (parity: python/paddle/vision/datasets/ — MNIST,
FashionMNIST, Cifar10/100, Flowers, VOC2012 + python/paddle/dataset/
download cache); port of paddle_tpu/vision/datasets.

The port never downloads: ``download=True`` cannot fetch; datasets read the
standard file formats from ``image_path``/``data_file`` (or
~/.cache/paddle/dataset like the reference's download cache), and
``FakeData`` provides deterministic synthetic samples for tests/benchmarks.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional

import numpy as np

from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.io.dataset_cache import CACHE_ROOT as _CACHE, require_file

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "VOC2012", "FakeData", "DatasetFolder", "ImageFolder"]


def _no_download(name: str, path: str):
    require_file(name, path)


class MNIST(Dataset):
    """IDX-format MNIST (reference: vision/datasets/mnist.py)."""

    NAME = "mnist"
    _IMAGE = {"train": "train-images-idx3-ubyte.gz",
              "test": "t10k-images-idx3-ubyte.gz"}
    _LABEL = {"train": "train-labels-idx1-ubyte.gz",
              "test": "t10k-labels-idx1-ubyte.gz"}

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = True,
                 backend: Optional[str] = None):
        assert mode in ("train", "test")
        base = os.path.join(_CACHE, self.NAME)
        image_path = image_path or os.path.join(base, self._IMAGE[mode])
        label_path = label_path or os.path.join(base, self._LABEL[mode])
        if not os.path.exists(image_path):
            _no_download(type(self).__name__, image_path)
        if not os.path.exists(label_path):
            _no_download(type(self).__name__, label_path)
        self.transform = transform
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(
            path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[:, :, None]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


class Cifar10(Dataset):
    """CIFAR python-pickle format (reference: vision/datasets/cifar.py)."""

    _URL_FILE = "cifar-10-python.tar.gz"
    _LABEL_KEY = b"labels"

    @staticmethod
    def _want_member(name: str, mode: str) -> bool:
        return (name.startswith("data_batch") if mode == "train"
                else name == "test_batch")

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = True,
                 backend: Optional[str] = None):
        assert mode in ("train", "test")
        data_file = data_file or os.path.join(_CACHE, "cifar",
                                              self._URL_FILE)
        if not os.path.exists(data_file):
            _no_download(type(self).__name__, data_file)
        self.transform = transform
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tf:
            for member in tf.getmembers():
                name = os.path.basename(member.name)
                if not self._want_member(name, mode):
                    continue
                d = pickle.load(tf.extractfile(member), encoding="bytes")
                images.append(d[b"data"])
                labels.extend(d[self._LABEL_KEY])
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].transpose(1, 2, 0)  # HWC uint8
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    _URL_FILE = "cifar-100-python.tar.gz"
    _LABEL_KEY = b"fine_labels"

    @staticmethod
    def _want_member(name: str, mode: str) -> bool:
        return name == ("train" if mode == "train" else "test")


class Flowers(Dataset):
    """Oxford 102 Flowers (reference: vision/datasets/flowers.py).

    Needs the reference's three files locally (never downloaded): 102flowers.tgz
    (jpg/image_NNNNN.jpg members), imagelabels.mat, setid.mat.  Samples:
    (image, [label]) with image decoded via PIL ('pil' backend) or numpy
    HWC ('cv2' backend), indices from setid's trnid/valid/tstid split
    (flowers.py:138-158)."""

    _FLAG = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        import scipy.io as scio
        assert mode in self._FLAG, mode
        self.backend = backend or "cv2"
        self.transform = transform
        data_file = data_file or os.path.join(_CACHE, "flowers",
                                              "102flowers.tgz")
        label_file = label_file or os.path.join(_CACHE, "flowers",
                                                "imagelabels.mat")
        setid_file = setid_file or os.path.join(_CACHE, "flowers",
                                                "setid.mat")
        for p, n in ((data_file, "Flowers"), (label_file, "Flowers labels"),
                     (setid_file, "Flowers setid")):
            if not os.path.exists(p):
                _no_download(n, p)
        self._tar = tarfile.open(data_file)
        self._members = {m.name: m for m in self._tar.getmembers()}
        self.labels = scio.loadmat(label_file)["labels"][0]
        self.indexes = scio.loadmat(setid_file)[self._FLAG[mode]][0]

    def __getitem__(self, idx):
        import io as _io

        from PIL import Image
        index = int(self.indexes[idx])
        label = np.array([self.labels[index - 1]])
        raw = self._tar.extractfile(
            self._members["jpg/image_%05d.jpg" % index]).read()
        image = Image.open(_io.BytesIO(raw))
        if self.backend == "cv2":
            image = np.array(image)
        if self.transform is not None:
            image = self.transform(image)
        return image, label.astype("int64")

    def __len__(self):
        return len(self.indexes)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs (reference:
    vision/datasets/voc2012.py): image list from
    ImageSets/Segmentation/{mode}.txt, (JPEGImages jpg, SegmentationClass
    png) decoded per backend."""

    _SET = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    _DATA = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    _LABEL = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        assert mode in ("train", "valid", "test"), mode
        flag = "val" if mode == "valid" else mode
        self.backend = backend or "cv2"
        self.transform = transform
        data_file = data_file or os.path.join(
            _CACHE, "voc2012", "VOCtrainval_11-May-2012.tar")
        if not os.path.exists(data_file):
            _no_download("VOC2012", data_file)
        self._tar = tarfile.open(data_file)
        self._members = {m.name: m for m in self._tar.getmembers()}
        self.data, self.labels = [], []
        for line in self._tar.extractfile(
                self._members[self._SET.format(flag)]):
            name = line.decode("utf-8").strip()
            if not name:
                continue
            self.data.append(self._DATA.format(name))
            self.labels.append(self._LABEL.format(name))

    def __getitem__(self, idx):
        import io as _io

        from PIL import Image
        img = Image.open(_io.BytesIO(self._tar.extractfile(
            self._members[self.data[idx]]).read()))
        lbl = Image.open(_io.BytesIO(self._tar.extractfile(
            self._members[self.labels[idx]]).read()))
        if self.backend == "cv2":
            img, lbl = np.array(img), np.array(lbl)
        if self.transform is not None:
            img = self.transform(img)
        if self.backend == "cv2":
            return img.astype("float32"), lbl.astype("float32")
        return img, lbl

    def __len__(self):
        return len(self.data)


class FakeData(Dataset):
    """Deterministic synthetic image dataset (test/bench stand-in for the
    download-cached datasets; the reference relies on real downloads)."""

    def __init__(self, num_samples: int = 256, image_shape=(1, 28, 28),
                 num_classes: int = 10, transform: Optional[Callable] = None,
                 seed: int = 0, data_format="CHW"):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.data_format = data_format
        self._seed = seed

    def __getitem__(self, idx):
        rng = np.random.default_rng(self._seed * 1_000_003 + idx)
        img = rng.standard_normal(self.image_shape).astype(np.float32)
        label = np.int64(rng.integers(0, self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.num_samples


class DatasetFolder(Dataset):
    """Directory-per-class image folder (reference:
    vision/datasets/folder.py).  Loads .npy/.npz images natively; other
    formats need a custom ``loader``."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        extensions = extensions or (".npy",)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for fname in sorted(os.listdir(d)):
                path = os.path.join(d, fname)
                ok = (is_valid_file(path) if is_valid_file
                      else fname.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append((path, self.class_to_idx[c]))

    @staticmethod
    def _default_loader(path):
        return np.load(path)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """Flat folder of images, no labels (reference: folder.py)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._default_loader
        extensions = extensions or (".npy",)
        self.samples = []
        for fname in sorted(os.listdir(root)):
            path = os.path.join(root, fname)
            ok = (is_valid_file(path) if is_valid_file
                  else fname.lower().endswith(tuple(extensions)))
            if ok and os.path.isfile(path):
                self.samples.append(path)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)
