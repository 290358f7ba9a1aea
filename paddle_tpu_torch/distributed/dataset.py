"""The PS datasets and the worker's training loop (port of paddle_tpu/
distributed/dataset.py).

``DatasetFactory().create_dataset("QueueDataset" | "InMemoryDataset")``
reads the multi-slot text files of ``set_filelist`` through the native
datafeed (``ops/native``): a :class:`QueueDataset` streams the C++
readers' batches, an :class:`InMemoryDataset` loads every instance into
host memory, shuffles it (``default_rng(0)`` unless a seed is given, as
the reference's) and batches it again.  ``train_from_dataset(step,
dataset)`` drains the batches into ``step`` through a converter, by
default one tensor a dense slot and (ids, lengths) a sparse one, made on
the default device (the card unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["DatasetFactory", "QueueDataset", "InMemoryDataset",
           "train_from_dataset"]


class DatasetFactory:
    """``create_dataset('QueueDataset' | 'InMemoryDataset')``."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        try:
            return {"QueueDataset": QueueDataset,
                    "InMemoryDataset": InMemoryDataset}[datafeed_class]()
        except KeyError:
            raise ValueError(f"unknown dataset class {datafeed_class!r}")


class _DatasetBase:
    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist: List[str] = []
        self.slots: List[Tuple[str, str, int]] = []
        self.queue_capacity = 16

    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num: int):
        self.thread_num = int(thread_num)

    def set_filelist(self, filelist: Sequence[str]):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        """The slot schema: (name, kind, dim) each, kind 'f' a dense
        float32 row, 'u' a sparse int64 id list."""
        slots = []
        for v in var_list:
            if isinstance(v, (tuple, list)) and len(v) == 3:
                slots.append((str(v[0]), str(v[1]), int(v[2])))
            else:
                raise TypeError(
                    "set_use_var expects (name, kind, dim) slot specs")
        self.slots = slots

    def set_pipe_command(self, cmd):      # the text protocol is built in
        self._pipe_command = cmd

    def _feed(self, batch_size: Optional[int] = None):
        from paddle_tpu_torch.ops.native import MultiSlotDataFeed
        if not self.slots:
            raise RuntimeError("set_use_var first")
        return MultiSlotDataFeed(
            self.slots, self.batch_size if batch_size is None else batch_size,
            files=self.filelist, nthreads=self.thread_num,
            capacity=self.queue_capacity)

    def batches(self):
        raise NotImplementedError


class QueueDataset(_DatasetBase):
    """Batches straight off the C++ reader threads."""

    def batches(self):
        yield from self._feed()


class InMemoryDataset(_DatasetBase):
    """Instances staged in host memory: ``load_into_memory``, then
    ``local_shuffle``, then batches of ``batch_size``."""

    LOAD_BATCH = 1024

    def __init__(self):
        super().__init__()
        self._instances: Optional[list] = None
        self._rng = np.random.default_rng(0)

    def load_into_memory(self):
        """Parse every file now and keep each instance's slot values: a
        dense row, or a sparse slot's ids.  The reference reads in a pass
        of batch size 1; here batches of ``LOAD_BATCH`` are split by row,
        which gives the same instances (in the same order at one reader
        thread) for a fraction of the calls across the library."""
        self._instances = []
        for b in self._feed(batch_size=self.LOAD_BATCH):
            cols = []
            for name, kind, _dim in self.slots:
                if kind == "f":
                    cols.append((name, list(b[name])))
                else:
                    ids, lens = b[name]
                    cuts = np.cumsum(lens)[:-1]
                    cols.append((name, np.split(ids, cuts)))
            rows = len(cols[0][1])
            self._instances.extend({name: vals[r] for name, vals in cols}
                                   for r in range(rows))

    def local_shuffle(self, seed: Optional[int] = None):
        if self._instances is None:
            raise RuntimeError("load_into_memory first")
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._rng.shuffle(self._instances)

    def global_shuffle(self, fleet=None, thread_num: int = 12):
        """A local shuffle: each process shuffles the files it was given
        (the reference's, for its single-controller feed)."""
        self.local_shuffle()

    def release_memory(self):
        self._instances = None

    def get_memory_data_size(self, fleet=None):
        return len(self._instances or [])

    def batches(self):
        if self._instances is None:
            raise RuntimeError("load_into_memory first")
        bs = self.batch_size
        for i in range(0, len(self._instances), bs):
            chunk = self._instances[i:i + bs]
            out = {}
            for name, kind, _dim in self.slots:
                if kind == "f":
                    out[name] = np.stack([c[name] for c in chunk])
                else:
                    ids = np.concatenate([c[name] for c in chunk])
                    lens = np.array([len(c[name]) for c in chunk], np.int64)
                    out[name] = (ids, lens)
            yield out


def _default_converter(slots, device=None):
    """A batch dict -> tensors in slot order on ``device`` (the default
    device when None), a sparse slot as (ids, lengths)."""
    dev = resolve_device(device)

    def convert(batch):
        args = []
        for name, kind, _dim in slots:
            if kind == "f":
                args.append(torch.as_tensor(batch[name], device=dev))
            else:
                ids, lens = batch[name]
                args.append(torch.as_tensor(ids, device=dev))
                args.append(torch.as_tensor(lens, device=dev))
        return args
    return convert


def train_from_dataset(step, dataset, converter: Optional[Callable] = None,
                       epochs: int = 1, print_period: int = 100,
                       fetch_handler: Optional[Callable] = None,
                       debug: bool = False, device=None):
    """Drain ``dataset``'s batches into ``step`` (a train step, or any
    callable taking the converted batch and returning its loss) for
    ``epochs`` passes; returns each epoch's mean loss.  ``converter``
    defaults to the slots in order on ``device``.  A pass with no batch
    raises."""
    conv = converter or _default_converter(dataset.slots, device)
    epoch_losses = []
    it = 0
    for _epoch in range(epochs):
        losses = []
        t0 = time.time()
        for batch in dataset.batches():
            loss = step(*conv(batch))
            losses.append(float(loss.detach() if isinstance(
                loss, torch.Tensor) else np.asarray(loss)))
            it += 1
            if fetch_handler is not None and it % print_period == 0:
                fetch_handler(it, losses[-1])
            elif debug and it % print_period == 0:
                print(f"iter {it}: loss {losses[-1]:.6f} "
                      f"({it / (time.time() - t0):.1f} it/s)")
        if not losses:
            raise RuntimeError("dataset produced no batches "
                               "(set_filelist/set_use_var?)")
        epoch_losses.append(float(np.mean(losses)))
    return epoch_losses
