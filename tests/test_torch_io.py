"""The port's ``io`` (paddle_tpu_torch/io/__init__.py, io/_worker.py)
against the reference's on the CPU.

Index orders are compared exactly: the samplers, ``random_split`` and
``DistributedBatchSampler`` (shuffled epochs, ``reshard`` mid-epoch) draw
the reference's numpy streams for the same int seed or numpy Generator.
A port ``Generator`` seeds numpy from its own stream: reproducible from
its seed, not the reference's order (stated in ``io``'s docstring).
Collates are compared bitwise, values and dtypes.  The threaded
DataLoader yields the sequential loader's stream.  The process workers
(spawned, this file only) collate in the worker bitwise the parent's
collate, send back their stage times and counter deltas, see no card
(``CUDA_VISIBLE_DEVICES`` empty before torch is imported there), and
surface a killed worker and a ``timeout`` as RuntimeErrors.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.tensor.random import Generator

from torch_io_common import CountingSquares, DiesAt, SlowAt, Squares


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("seed", [0, 7])
def test_random_orders_match_reference(seed):
    """RandomSampler (with and without replacement, num_samples),
    random_split and a shuffled BatchSampler: the reference's indices for
    the same int seed and for the same numpy Generator state."""
    ds = _Range(37)
    for kw in ({}, {"replacement": True}, {"num_samples": 11}):
        want = list(jio.RandomSampler(ds, generator=seed, **kw))
        assert list(tio.RandomSampler(ds, generator=seed, **kw)) == want
        got = list(tio.RandomSampler(
            ds, generator=np.random.default_rng(seed), **kw))
        assert got == want
    want = [list(s.indices) for s in jio.random_split(ds, [20, 17], seed)]
    assert [list(s.indices) for s in tio.random_split(
        ds, [20, 17], seed)] == want
    js = jio.BatchSampler(sampler=jio.RandomSampler(ds, generator=seed),
                          batch_size=5, drop_last=True)
    ts = tio.BatchSampler(sampler=tio.RandomSampler(ds, generator=seed),
                          batch_size=5, drop_last=True)
    assert [list(b) for b in ts] == [list(b) for b in js] and \
        len(ts) == len(js) == 7
    np.random.seed(seed)
    want = list(jio.WeightedRandomSampler(np.arange(1, 38), 9))
    np.random.seed(seed)
    assert list(tio.WeightedRandomSampler(np.arange(1, 38), 9)) == want


def test_port_generator_orders_are_reproducible():
    """A port Generator's shuffle: one order per seed, two epochs of one
    stream differ, another seed differs."""
    ds = _Range(50)

    def orders(seed):
        s = tio.RandomSampler(ds, generator=Generator(seed, device="cpu"))
        return list(s), list(s)
    a, b = orders(3), orders(3)
    assert a == b and a[0] != a[1] and orders(4)[0] != a[0]
    assert sorted(a[0]) == list(range(50))


def test_distributed_sampler_and_reshard_match_reference():
    """DistributedBatchSampler on 3 ranks over 40 samples, shuffled: the
    reference's batches for epochs 0 and 1; after 2 batches of epoch 1,
    reshard to 2 ranks and the remaining batches are the reference's,
    covering the unconsumed samples once (padding only in the last
    stride)."""
    ds = _Range(40)

    def run(io):
        out = []
        samplers = [io.DistributedBatchSampler(ds, 4, num_replicas=3,
                                               rank=r, shuffle=True)
                    for r in range(3)]
        for epoch in (0, 1):
            for s in samplers:
                s.set_epoch(epoch)
            out.append([[list(b) for b in s] for s in samplers])
        consumed = [s.reshard(r, 2, membership_epoch=1,
                              consumed_batches=2)
                    for r, s in enumerate(samplers[:2])]
        out.append([[list(b) for b in s] for s in samplers[:2]])
        out.append([consumed, [len(s) for s in samplers[:2]]])
        return out
    want, got = run(jio), run(tio)
    assert got == want
    epoch1 = [i for rank in want[1] for b in rank[:2] for i in b]
    rest = [i for rank in want[2] for b in rank for i in b]
    assert set(epoch1) | set(rest) == set(range(40))
    assert want[3][0] == [24, 24]


def _collate_cases():
    rng = np.random.default_rng(5)
    arr = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(4)]
    ints = [int(i) for i in rng.integers(0, 9, 4)]
    floats = [float(f) for f in rng.standard_normal(4)]
    return {
        "arrays": arr,
        "tuples": [(a, i) for a, i in zip(arr, ints)],
        "dicts": [{"x": a, "f": f, "s": "t"} for a, f in zip(arr, floats)],
        "ints": ints,
    }


@pytest.mark.parametrize("case", ["arrays", "tuples", "dicts", "ints"])
def test_collates_match_reference(case):
    """numpy_collate bitwise the reference's (one contiguous array a
    field); default_collate_fn tensors on the CPU with the reference's
    values and dtypes."""
    batch = _collate_cases()[case]

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (list, tuple)) and x and not isinstance(x[0], str):
            return [v for e in x for v in flat(e)]
        return [x]
    want = flat(jio.numpy_collate(batch))
    got = flat(tio.numpy_collate(batch))
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.flags.c_contiguous
            assert np.array_equal(g, w)
        else:
            assert g == w
    want = flat(jio.default_collate_fn(batch))
    got = flat(tio.default_collate_fn(batch, device="cpu"))
    for g, w in zip(got, want):
        if isinstance(w, str) or (isinstance(w, list) and isinstance(
                w[0], str)):
            assert g == w
            continue
        w = np.asarray(w._data)
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


def test_threaded_loader_is_the_sequential_stream():
    """DataLoader(num_workers=3, threads), shuffled from a seed: the
    sequential loader's batches in order, bitwise; the reference's
    sequential loader yields the same values; len and drop_last."""
    ds = Squares()

    def loader(io, workers, **kw):
        sampler = io.BatchSampler(
            sampler=io.RandomSampler(ds, generator=11), batch_size=5,
            drop_last=True)
        return io.DataLoader(ds, batch_sampler=sampler,
                             num_workers=workers, **kw)
    seq = [(x.numpy(), y.numpy()) for x, y in loader(tio, 0, places="cpu")]
    thr = [(x.numpy(), y.numpy()) for x, y in loader(tio, 3, places="cpu")]
    ref = [(np.asarray(x._data), np.asarray(y._data))
           for x, y in loader(jio, 0)]
    assert len(seq) == len(thr) == len(ref) == 4
    for (a, b), (c, d), (e, f) in zip(seq, thr, ref):
        assert np.array_equal(a, c) and np.array_equal(b, d)
        assert np.array_equal(a, e) and np.array_equal(b, f)
        assert a.dtype == e.dtype and b.dtype == f.dtype


def test_process_workers():
    """use_process_workers with collate_in_worker: the stream bitwise the
    parent-side collate's, stage times and the worker's counter deltas
    come back, the worker sees no card; a killed worker and a timeout
    raise RuntimeErrors naming them."""
    ds = CountingSquares()
    before = monitor.get_stat("test_worker_fetches_total")
    seq = list(tio.DataLoader(ds, batch_size=6,
                              collate_fn=tio.numpy_collate))
    dl = tio.DataLoader(ds, batch_size=6, num_workers=1,
                        use_process_workers=True, collate_in_worker=True)
    got = []
    for b in dl:
        got.append(b)
        assert {"decode_ms", "collate_ms"} <= set(dl.last_stage_ms)
    assert len(got) == len(seq) == 4
    for g, s in zip(got, seq):
        for a, b in zip(g[:3], s[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # the worker's fetches folded into this process's registry, on top
    # of the sequential loader's own
    assert monitor.get_stat("test_worker_fetches_total") - before == 48
    views = set(got[0][3])
    assert views == {"('', '1', 0)"}, views
    assert int(got[0][2][0]) == 0

    with pytest.raises(RuntimeError, match="worker 0 died"):
        list(tio.DataLoader(DiesAt(7), batch_size=4, num_workers=1,
                            use_process_workers=True))
    with pytest.raises(RuntimeError, match="timed out"):
        list(tio.DataLoader(SlowAt(4, 30.0), batch_size=4, num_workers=1,
                            use_process_workers=True, timeout=2))
