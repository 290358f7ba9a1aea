"""The native datafeed and the PS datasets of the port
(paddle_tpu_torch/ops/native, csrc/datafeed.cpp,
paddle_tpu_torch/distributed/dataset.py) against the reference's, on the
CPU: the batches of one reader thread bitwise the reference's, of three
the same multiset, the same errors and the single pass; the factory, the
in-memory shuffle of the reference's seed, train_from_dataset's losses,
the library's place under build/paddle_tpu_torch/, and the default
converter's device.

Tolerances: batches bitwise (both parse with the same C++ source);
train_from_dataset's epoch losses within 1e-5 of the largest (f32 in two
libraries).  Files of at most 48 records."""
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import distributed as jdist
from paddle_tpu.ops import native as jnative
import paddle_tpu_torch as tpt
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import dataset as tdataset
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.nn import Embedding, Layer, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import native
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.optimizer import Adam

ROOT = Path(__file__).resolve().parents[1]
SLOTS = [("dense", "f", 2), ("ids", "u", 0), ("label", "f", 1)]
REL = 1e-5


def _write(path, n, seed=0):
    """n records of a 2-float dense slot, 1-4 ids and a label."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            d = rng.standard_normal(2).round(3)
            k = int(rng.integers(1, 5))
            ids = rng.integers(0, 50, size=k)
            f.write(f"2 {d[0]} {d[1]} {k} " + " ".join(map(str, ids))
                    + f" 1 {float(d[0] > 0)}\n")
    return str(path)


def _files(tmp_path, n_files=3, rows=16):
    return [_write(tmp_path / f"part-{j}", rows + j, seed=j)
            for j in range(n_files)]


def _batches(mod, files, nthreads, batch_size=5):
    return list(mod.MultiSlotDataFeed(SLOTS, batch_size, files=files,
                                      nthreads=nthreads))


def _records(batches):
    """Every record as (dense, ids, label) bytes."""
    out = []
    for b in batches:
        ids, lens = b["ids"]
        offs = np.concatenate([[0], np.cumsum(lens)])
        for r in range(len(lens)):
            out.append((b["dense"][r].tobytes(),
                        ids[offs[r]:offs[r + 1]].tobytes(),
                        b["label"][r].tobytes()))
    return out


def test_one_thread_batches_bitwise_the_references(tmp_path):
    files = _files(tmp_path)
    got, want = _batches(native, files, 1), _batches(jnative, files, 1)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name, kind, _ in SLOTS:
            a, b = (g[name], w[name]) if kind == "f" else (
                np.concatenate(g[name]), np.concatenate(w[name]))
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_three_threads_the_same_multiset(tmp_path):
    files = _files(tmp_path)
    got = _records(_batches(native, files, 3))
    want = _records(_batches(jnative, files, 1))
    assert len(got) == 51 and sorted(got) == sorted(want)


def test_errors_and_the_single_pass(tmp_path):
    """A bad record, a missing file: the reference's messages; a second
    pass over one feed raises."""
    bad = tmp_path / "bad"
    bad.write_text("2 1.0 2.0 1 5 1 0\n9 1.0\n")
    for files in ([str(bad)], [str(tmp_path / "nope")]):
        msgs = []
        for mod in (native, jnative):
            with pytest.raises(RuntimeError,
                               match="bad record|cannot open") as e:
                _batches(mod, files, 1, batch_size=4)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    feed = native.MultiSlotDataFeed(SLOTS, 2, files=_files(tmp_path, 1))
    list(feed)
    with pytest.raises(RuntimeError, match="single-pass"):
        next(iter(feed))
    with pytest.raises(RuntimeError, match="add_file after start"):
        feed.add_file("x")


def test_library_is_built_under_build_dir():
    """The library lies under build/paddle_tpu_torch/, named by the hash of
    its source and flags; nothing is written beside the port's sources."""
    assert native.native_available()
    path = Path(native.lib_path())
    assert path.parent == _build.BUILD_DIR == ROOT / "build" / \
        "paddle_tpu_torch"
    assert path.name.startswith("datafeed-") and path.exists()
    assert not list((ROOT / "paddle_tpu_torch").rglob("*.so"))


def test_factory_dispatch():
    for mod in (tdist, jdist):
        f = mod.DatasetFactory()
        assert isinstance(f.create_dataset("QueueDataset"), mod.QueueDataset)
        assert isinstance(f.create_dataset("InMemoryDataset"),
                          mod.InMemoryDataset)
        with pytest.raises(ValueError):
            f.create_dataset("Nope")
        with pytest.raises(TypeError):
            f.create_dataset().set_use_var(["dense"])


def _inmemory(mod, files, seed=None, shuffles=1):
    ds = mod.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(4)
    ds.set_thread(1)
    ds.set_filelist(files)
    ds.set_use_var(SLOTS)
    ds.load_into_memory()
    for _ in range(shuffles):
        if seed is None:
            ds.global_shuffle()
        else:
            ds.local_shuffle(seed=seed)
    return ds


@pytest.mark.parametrize("seed", [None, 7], ids=["default_rng0", "seed7"])
def test_inmemory_shuffle_is_the_references(tmp_path, seed):
    """load_into_memory, two shuffles (the reference's default_rng(0), or
    a given seed), batches of 4: bitwise the reference's."""
    files = _files(tmp_path)
    got = list(_inmemory(tdist, files, seed, 2).batches())
    want = list(_inmemory(jdist, files, seed, 2).batches())
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert np.array_equal(g["dense"], w["dense"])
        assert np.array_equal(g["ids"][0], w["ids"][0])
        assert np.array_equal(g["ids"][1], w["ids"][1])
    ds = _inmemory(tdist, files)
    assert ds.get_memory_data_size() == 51
    ds.release_memory()
    with pytest.raises(RuntimeError, match="load_into_memory"):
        list(ds.batches())


class _RankNet(Layer):
    def __init__(self):
        super().__init__()
        self.emb = Embedding(50, 4, device="cpu")
        self.fc = Linear(4 + 2, 1, device="cpu")

    def forward(self, dense, ids, lens):
        seg = tpt.lengths_to_segment_ids(lens)
        pooled = F.embedding_bag(ids, self.emb.weight, seg, mode="mean")
        return self.fc(torch.cat([pooled, dense], 1))


class _JRankNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(50, 4)
        self.fc = jnn.Linear(4 + 2, 1)

    def forward(self, dense, ids, lens):
        seg = paddle.lengths_to_segment_ids(lens)
        pooled = JF.embedding_bag(ids, self.emb.weight, seg, mode="mean")
        return self.fc(paddle.concat([pooled, dense], axis=1))


def test_train_from_dataset_as_the_reference(tmp_path):
    """An embedding-bag model trained eagerly by train_from_dataset over an
    InMemoryDataset (shuffled, seed 1) with the default converter on the
    CPU, 3 epochs: the epoch losses within 1e-5 of the largest of the
    reference's, falling; fetch_handler sees every second iteration."""
    files = [_write(tmp_path / f"p{j}", 24, seed=j) for j in range(2)]
    paddle.seed(0)
    jm = _JRankNet()
    init = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    jo = paddle.optimizer.Adam(learning_rate=0.05,
                               parameters=jm.parameters())

    def jstep(dense, ids, lens, label):
        loss = JF.binary_cross_entropy_with_logits(jm(dense, ids, lens),
                                                   label)
        loss.backward()
        jo.step()
        jo.clear_grad()
        return loss

    m = load_named_params(_RankNet(), init)
    o = Adam(learning_rate=0.05, parameters=m.parameters())

    def step(dense, ids, lens, label):
        loss = F.binary_cross_entropy_with_logits(m(dense, ids, lens), label)
        loss.backward()
        o.step()
        o.clear_grad()
        return loss

    def dataset(mod):
        ds = mod.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_batch_size(6)
        ds.set_filelist(files)
        ds.set_use_var(SLOTS)
        ds.load_into_memory()
        ds.local_shuffle(seed=1)
        return ds

    want = jdist.train_from_dataset(jstep, dataset(jdist), epochs=3)
    seen = []
    got = tdist.train_from_dataset(step, dataset(tdist), epochs=3,
                                   device="cpu", print_period=2,
                                   fetch_handler=lambda i, l: seen.append(i))
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    assert got[-1] < got[0]
    assert seen == list(range(2, 25, 2))


def test_queue_dataset_streams_and_the_empty_one_raises(tmp_path):
    ds = tdist.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(5)
    ds.set_thread(2)
    ds.set_filelist(_files(tmp_path))
    with pytest.raises(RuntimeError, match="set_use_var"):
        list(ds.batches())
    ds.set_use_var(SLOTS)
    assert sum(b["dense"].shape[0] for b in ds.batches()) == 51
    empty = tmp_path / "empty"
    empty.write_text("")
    ds.set_filelist([str(empty)])
    for mod in (tdist, jdist):
        with pytest.raises(RuntimeError, match="no batches"):
            mod.train_from_dataset(lambda *a: 0.0, ds, converter=list)


def test_default_converter_needs_the_card_unless_told(monkeypatch):
    """The default converter makes tensors on the default device, the
    card: without one it raises naming is_available; device="cpu" gives
    the slots in order, a sparse slot as (ids, lengths)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tdataset._default_converter(SLOTS)
    batch = {"dense": np.ones((2, 2), np.float32),
             "ids": (np.array([3, 4, 5]), np.array([1, 2])),
             "label": np.zeros((2, 1), np.float32)}
    out = tdataset._default_converter(SLOTS, "cpu")(batch)
    assert [tuple(t.shape) for t in out] == [(2, 2), (3,), (2,), (2, 1)]
    assert all(t.device.type == "cpu" for t in out)
    assert out[1].dtype == torch.int64
