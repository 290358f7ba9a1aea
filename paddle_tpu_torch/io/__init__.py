"""Data pipeline of the port (port of paddle_tpu/io/__init__.py; parity:
python/paddle/io/ — Dataset/DataLoader/Samplers).

The DataLoader is a host-side prefetch pipeline: worker threads by
default (numpy collation releases the GIL), or worker processes
(``use_process_workers=True``, spawned children that never touch the
card, ``io/_worker.py``).  ``default_collate_fn`` stacks samples into
tensors on the loader's device (``places``, the port's default device
when None); ``numpy_collate`` keeps batches on the host for the ingest
pipeline (``io/pipeline.py``), whose transfer stage owns the copy.

Shuffles draw from numpy: an int seed or a numpy ``Generator`` gives the
reference's index order.  A port ``Generator`` seeds numpy from one draw
of its own stream, so its order is reproducible from its seed but is not
the reference's (the reference seeds from its JAX key stream).
"""
from __future__ import annotations

import functools
import math
import queue as _queue
import threading

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "DataLoader",
           "get_worker_info", "numpy_collate", "default_collate_fn",
           "MultiSlotDataFeed", "IngestPipeline", "SampleCache",
           "CachedDataset"]


def __getattr__(name):
    # lazy: the native engine compiles its .so on first touch, and the
    # ingest plane pulls in chaos/monitor/flags only when actually used
    if name == "MultiSlotDataFeed":
        from paddle_tpu_torch.ops.native import MultiSlotDataFeed
        return MultiSlotDataFeed
    if name in ("IngestPipeline", "SampleCache", "CachedDataset"):
        from paddle_tpu_torch.io import pipeline as _pipeline
        return getattr(_pipeline, name)
    raise AttributeError(name)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def _as_np_rng(generator):
    """Normalize a ``generator`` argument into a numpy Generator.

    Accepts ``None`` (a fresh unseeded stream), an int seed or a
    ``np.random.Generator`` (the reference's streams, so the same index
    order), or a port ``Generator`` / ``torch.Generator``: numpy is then
    seeded from one 63-bit draw of that stream, so ``Generator(seed)``
    gives one order per seed (not the reference's, whose seed comes from
    its JAX key stream)."""
    if generator is None:
        return np.random.default_rng()
    if isinstance(generator, np.random.Generator):
        return generator
    if isinstance(generator, (int, np.integer)):
        return np.random.default_rng(int(generator))
    gen = generator
    if callable(getattr(generator, "generator", None)):   # port Generator
        gen = generator.generator(generator._device)
    if isinstance(gen, torch.Generator):
        seed = torch.randint(0, 2 ** 63 - 1, (), generator=gen,
                             device=gen.device)
        return np.random.default_rng(int(seed))
    raise TypeError(
        f"generator must be None, an int seed, numpy Generator, or "
        f"a port / torch Generator — got {type(generator).__name__}")


def random_split(dataset, lengths, generator=None):
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError("sum of lengths != dataset size")
    perm = _as_np_rng(generator).permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """``generator`` (int seed / numpy Generator / paddle Generator) is
    the shuffle's RNG — a stateful stream, so consecutive epochs draw
    different-but-reproducible permutations from one seed."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        self._rng = _as_np_rng(generator) if generator is not None else None

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self._rng if self._rng is not None else _as_np_rng(None)
        if self.replacement:
            return iter(rng.integers(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset across data-parallel ranks (parity:
    python/paddle/io/DistributedBatchSampler; rank/nranks come from
    paddle_tpu_torch.distributed.ParallelEnv).

    **Elastic contract**: the global sample order for a data epoch
    depends only on ``(shuffle seed, epoch)`` — never on membership —
    and each rank's shard is a stride over the *unconsumed suffix* of
    that order.  :meth:`reshard` moves the consumed-samples cursor and
    adopts a new ``(rank, nranks, membership_epoch)``, so a mid-epoch
    ``elastic.reform()`` re-partitions exactly the not-yet-trained
    samples across the surviving ranks — deterministically, with no
    sample lost and none duplicated (padding duplicates only ever land
    in the final partial stride)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from paddle_tpu_torch.distributed.parallel import ParallelEnv
            env = ParallelEnv()
            num_replicas = num_replicas or env.nranks
            rank = rank if rank is not None else env.local_rank
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.membership_epoch = None
        self._consumed = 0           # global samples behind the cursor
        self._recount()

    def _recount(self):
        remaining = max(0, len(self.dataset) - self._consumed)
        self.num_samples = int(math.ceil(remaining / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def _global_indices(self):
        """The epoch's membership-independent global sample order."""
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        return indices

    def __iter__(self):
        indices = self._global_indices()[self._consumed:]
        if not indices:
            return
        # pad by CYCLING to an even shard: the old `indices[:pad]` slice
        # under-pads whenever pad > len(indices) (nranks > dataset),
        # yielding unequal shards and a hang at the collective
        pad = self.total_size - len(indices)
        if pad > 0:
            reps = -(-pad // len(indices))
            indices = indices + (indices * reps)[:pad]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        """Start a fresh data epoch: new shuffle order, cursor reset."""
        self.epoch = epoch
        self._consumed = 0
        self._recount()

    def reshard(self, rank, nranks, membership_epoch=None,
                consumed_batches=0):
        """Adopt a new membership mid-epoch.  ``consumed_batches`` is
        the number of batches THIS sampler already yielded this epoch
        (identical on every rank under data-parallel lockstep); the
        consumed global prefix is ``consumed_batches × batch_size ×
        old_nranks``, and the next ``__iter__`` yields only the
        remaining samples, strided over the new ranks."""
        self._consumed = min(
            len(self.dataset),
            self._consumed + int(consumed_batches) * self.batch_size
            * self.nranks)
        self.local_rank = int(rank)
        self.nranks = int(nranks)
        if membership_epoch is not None:
            self.membership_epoch = int(membership_epoch)
        self._recount()
        return self._consumed

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, "info", None)


def numpy_collate(batch):
    """Collate to contiguous numpy arrays — never a device tensor.

    The worker-side collate of the ingest plane (io/pipeline.py): one
    C-contiguous array per field instead of B per-sample objects, cheap
    to pickle across the worker boundary, with the device transfer left
    to the parent's pipelined transfer stage."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.ascontiguousarray(
            np.stack([s.detach().cpu().numpy() for s in batch]))
    if isinstance(sample, np.ndarray):
        return np.ascontiguousarray(np.stack(batch))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [numpy_collate(list(items)) for items in transposed]
    if isinstance(sample, dict):
        return {k: numpy_collate([d[k] for d in batch]) for k in sample}
    if isinstance(sample, str):
        return list(batch)
    return np.asarray(batch)


def _tensor(arr, device):
    from paddle_tpu_torch.device import resolve_device
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        resolve_device(device))


def default_collate_fn(batch, device=None):
    """Stack a list of samples into tensors on ``device`` (the port's
    default device when None), field by field as the reference's, with
    numpy's dtypes (a list of Python floats is float64)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        from paddle_tpu_torch.device import resolve_device
        return torch.stack([s.detach() for s in batch]).to(
            resolve_device(device))
    if isinstance(sample, np.ndarray):
        return _tensor(np.stack(batch), device)
    if isinstance(sample, (int, float)):
        return _tensor(np.asarray(batch), device)
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(items), device)
                for items in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch], device)
                for k in sample}
    if isinstance(sample, str):
        return list(batch)
    return _tensor(np.asarray(batch), device)


def _place(places):
    """The loader's device from the reference's ``places`` (a device, a
    name, or a list of them: the first)."""
    if isinstance(places, (list, tuple)):
        places = places[0] if places else None
    return None if places is None else str(places)


class DataLoader:
    """Prefetching loader (reference: fluid/reader.py:149 DataLoader +
    dataloader/dataloader_iter.py worker pool).  ``places`` is the device
    ``default_collate_fn`` puts batches on (the port's default device,
    the card, when None)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, use_shared_memory=True,
                 prefetch_factor=2, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process_workers=False,
                 collate_in_worker=False):
        self.dataset = dataset
        self.device = _place(places)
        self.collate_fn = collate_fn or functools.partial(
            default_collate_fn, device=self.device)
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        # use_process_workers=True → real OS worker processes (the
        # reference's _DataLoaderIterMultiProcess); False keeps the thread
        # pool, which is faster to start and fine for numpy-bound datasets
        self.use_process_workers = use_process_workers
        # collate_in_worker=True → workers run a numpy-pure collate at
        # batch granularity (collate_fn or numpy_collate) and ship ONE
        # contiguous array per field; the loader then yields numpy
        # batches (the ingest pipeline's transfer stage owns the device
        # copy) and records worker-measured decode/collate wall time in
        # self.last_stage_ms
        self.collate_in_worker = collate_in_worker
        if collate_in_worker and (not use_process_workers
                                  or num_workers < 1):
            raise ValueError("collate_in_worker=True requires "
                             "use_process_workers=True and "
                             "num_workers >= 1 (with num_workers=0 the "
                             "loader decodes in-parent and the worker "
                             "collate would silently never run)")
        if collate_in_worker and collate_fn is None:
            self.collate_fn = numpy_collate
        self.last_stage_ms: dict = {}
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.is_iterable = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif self.is_iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self.is_iterable:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not getattr(self, "drop_last", False):
            yield self.collate_fn(batch)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self.is_iterable:
            yield from self._iter_iterable()
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        if self.use_process_workers:
            yield from self._iter_multiprocess()
            return
        # threaded prefetch pipeline with backpressure: in-order tickets, a
        # bounded buffer (prefetch_factor × num_workers), early-exit support
        capacity = self.prefetch_factor * self.num_workers
        index_iter = iter(self.batch_sampler)
        lock = threading.Lock()
        ticket = [0]
        out_buf: dict = {}
        cond = threading.Condition()
        stop = threading.Event()
        next_out = [0]

        def worker():
            while not stop.is_set():
                with lock:
                    try:
                        my_ticket = ticket[0]
                        indices = next(index_iter)
                        ticket[0] += 1
                    except StopIteration:
                        return
                try:
                    data = self._fetch(indices)
                except Exception as e:  # propagate to consumer
                    data = e
                with cond:
                    # backpressure: don't run ahead of the consumer
                    while (my_ticket - next_out[0] >= capacity
                           and not stop.is_set()):
                        cond.wait(timeout=1.0)
                    if stop.is_set():
                        return
                    out_buf[my_ticket] = data
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(self.batch_sampler)):
                with cond:
                    while i not in out_buf:
                        if not any(t.is_alive() for t in threads) and \
                                i not in out_buf:
                            return
                        cond.wait(timeout=1.0)
                    data = out_buf.pop(i)
                    next_out[0] = i + 1
                    cond.notify_all()
                if isinstance(data, Exception):
                    raise data
                yield data
        finally:
            stop.set()
            with cond:
                cond.notify_all()

    def _iter_multiprocess(self):
        """Real worker processes (dataloader_iter.py
        _DataLoaderIterMultiProcess): spawn children, feed index batches,
        reorder results, collate in the parent — or, with
        ``collate_in_worker=True``, receive worker-collated contiguous
        numpy batches plus their measured decode/collate wall time (see
        io/_worker.py).

        Fault surface: a worker killed mid-epoch raises a clean
        RuntimeError naming the worker (tickets map to workers
        round-robin, so a dead child with an outstanding ticket and an
        empty result queue can never be progress); ``timeout=`` bounds
        the per-batch wait the same way."""
        import multiprocessing as mp

        from paddle_tpu_torch.io._worker import (ExceptionWrapper,
                                                 hidden_card, worker_loop)

        worker_collate = self.collate_fn if self.collate_in_worker else None
        ctx = mp.get_context("spawn")
        index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        result_queue = ctx.Queue()
        procs = [
            ctx.Process(
                target=worker_loop,
                args=(self.dataset, index_queues[w], result_queue,
                      self.worker_init_fn, w, worker_collate),
                daemon=True)
            for w in range(self.num_workers)]
        with hidden_card():          # children must not take the card
            for p in procs:
                p.start()

        capacity = self.prefetch_factor * self.num_workers
        batches = list(self.batch_sampler)
        n = len(batches)
        sent = 0
        pending: dict = {}
        timeout = self.timeout or None
        try:
            while sent < min(capacity, n):
                index_queues[sent % self.num_workers].put(
                    (sent, batches[sent]))
                sent += 1
            for i in range(n):
                waited = 0.0
                while i not in pending:
                    poll = min(1.0, timeout) if timeout else 1.0
                    try:
                        got = result_queue.get(timeout=poll)
                    except _queue.Empty:
                        waited += poll
                        if timeout and waited >= timeout:
                            raise RuntimeError(
                                f"DataLoader timed out after {timeout}s "
                                f"waiting for batch {i}")
                        # a dead worker with an outstanding ticket can
                        # never produce it: surface a clean error, not
                        # a hang (ticket t belongs to worker t % W)
                        dead = {w for w in range(self.num_workers)
                                if not procs[w].is_alive()}
                        if dead and result_queue.empty():
                            lost = [t for t in range(i, sent)
                                    if t not in pending and
                                    t % self.num_workers in dead]
                            if lost:
                                w = lost[0] % self.num_workers
                                raise RuntimeError(
                                    f"DataLoader worker {w} died "
                                    f"(exitcode="
                                    f"{procs[w].exitcode}) with batch "
                                    f"{lost[0]} outstanding")
                        continue
                    ticket, data = got[0], got[1]
                    pending[ticket] = (data, got[2] if len(got) > 2
                                       else None)
                data, stage_ms = pending.pop(i)
                if sent < n:
                    index_queues[sent % self.num_workers].put(
                        (sent, batches[sent]))
                    sent += 1
                if isinstance(data, ExceptionWrapper):
                    data.reraise()
                if worker_collate is not None:
                    self.last_stage_ms = stage_ms or {}
                    # counters the worker recorded for this batch (e.g.
                    # SampleCache hits/misses) — fold into the parent's
                    # registry, the one export_prometheus() reads
                    deltas = self.last_stage_ms.pop("stat_deltas", None)
                    if deltas:
                        from paddle_tpu_torch.framework import monitor
                        for name, delta in deltas.items():
                            monitor.stat_add(name, delta)
                    yield data          # already a contiguous numpy batch
                else:
                    yield self.collate_fn(data)
        finally:
            for q in index_queues:
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
            for p in procs:
                p.join(timeout=2.0)
                if p.is_alive():
                    p.terminate()
