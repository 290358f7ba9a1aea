"""``paddle.dataset.common`` (reference: dataset/common.py; port of
paddle_tpu/dataset/common.py) — the shared reader utilities 1.x scripts
import.  ``download`` never fetches: it resolves a file already in the
cache and raises otherwise (md5file/split/cluster_files_reader keep
their semantics)."""
from __future__ import annotations

import glob
import hashlib
import os
import pickle

DATA_HOME = os.path.expanduser("~/.cache/paddle/dataset")


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: str, save_name=None):
    """The cached file of ``url``: ``DATA_HOME/module_name/`` then
    ``save_name`` or the URL's file name, checked against ``md5sum`` when
    one is given.  Never fetches: an absent file raises ``RuntimeError``
    naming where to place it."""
    name = save_name or os.path.basename(url.split("?")[0])
    path = os.path.join(DATA_HOME, module_name, name)
    if not os.path.exists(path):
        raise RuntimeError(
            f"{url} is not in the local dataset cache ({path}) and the "
            "port does not download: place the file there")
    if md5sum and md5file(path) != md5sum:
        raise IOError(f"cached file {path} fails its md5 check")
    return path


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """dataset/common.py split: dump a reader into line_count-sized
    pickle shards."""
    if not callable(reader):
        raise TypeError("reader should be callable")
    lines = []
    idx = 0
    for d in reader():
        lines.append(d)
        if len(lines) == line_count:
            with open(suffix % idx, "wb") as f:
                dumper(lines, f)
            lines = []
            idx += 1
    if lines:
        with open(suffix % idx, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """dataset/common.py cluster_files_reader: this trainer's shard of a
    split() output."""

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        for i, path in enumerate(file_list):
            if i % trainer_count == trainer_id:
                with open(path, "rb") as f:
                    for d in loader(f):
                        yield d

    return reader
