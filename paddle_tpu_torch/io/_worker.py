"""DataLoader worker-process loop (port of paddle_tpu/io/_worker.py).

Reference: python/paddle/fluid/dataloader/dataloader_iter.py
(_DataLoaderIterMultiProcess worker target at _worker_loop) — real OS
processes so python-heavy datasets/transforms escape the GIL, unlike the
thread pool used for numpy-releasing workloads.

Two shipping modes:

* **per-sample** (default, ``collate_fn=None``): workers run *dataset
  indexing only* and ship raw (numpy/python) samples back; collation to
  device tensors happens in the parent.
* **in-worker collate** (``collate_fn=`` a numpy-pure callable, e.g.
  ``io.numpy_collate``): the worker decodes+augments AND collates the
  whole batch into contiguous numpy arrays before pickling — one large
  array per field instead of B small ones, and never a device tensor
  (the transfer stage belongs to the parent's ingest pipeline).  Each
  result carries the measured decode and collate wall time and the
  worker's counter increments, so the parent can export them.

Children are spawned under :func:`hidden_card`: ``CUDA_VISIBLE_DEVICES``
is empty in their environment from exec on, before ``torch`` is imported
there, so a worker never creates a CUDA context on the card.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import traceback

_env_lock = threading.Lock()

#: set in a worker's environment (the reference's PADDLE_TPU_WORKER)
WORKER_ENV = "PADDLE_TPU_TORCH_WORKER"


@contextlib.contextmanager
def hidden_card():
    """Processes started inside see no card and carry ``WORKER_ENV=1``.
    The parent counts its cards first, so its own CUDA driver has read
    the variable before it changes here; the old values come back on
    exit."""
    import torch
    torch.cuda.device_count()
    with _env_lock:
        saved = {k: os.environ.get(k)
                 for k in ("CUDA_VISIBLE_DEVICES", WORKER_ENV)}
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        os.environ[WORKER_ENV] = "1"
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


class ExceptionWrapper:
    def __init__(self, exc: BaseException):
        self.msg = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))
        self.type_name = type(exc).__name__

    def reraise(self):
        raise RuntimeError(
            f"DataLoader worker raised {self.type_name}:\n{self.msg}")


_stat_snapshot: dict = {}


def _drain_stat_deltas():
    """Counter increments recorded in THIS worker process since the last
    drain (a worker's monitor registry is otherwise invisible: the
    parent's ``export_prometheus()`` reads only its own)."""
    from paddle_tpu_torch.framework import monitor
    now = monitor.all_stats()
    deltas = {k: v - _stat_snapshot.get(k, 0)
              for k, v in now.items() if v != _stat_snapshot.get(k, 0)}
    _stat_snapshot.clear()
    _stat_snapshot.update(now)
    return deltas


def worker_loop(dataset, index_queue, result_queue, worker_init_fn,
                worker_id: int, collate_fn=None):
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:                      # poison pill
            return
        ticket, indices = item
        try:
            t0 = time.perf_counter()
            samples = [dataset[i] for i in indices]
            if collate_fn is None:
                result_queue.put((ticket, samples))
                continue
            t1 = time.perf_counter()
            batch = collate_fn(samples)
            t2 = time.perf_counter()
            result_queue.put((ticket, batch,
                              {"decode_ms": (t1 - t0) * 1e3,
                               "collate_ms": (t2 - t1) * 1e3,
                               "stat_deltas": _drain_stat_deltas()}))
        except Exception as e:                # noqa: BLE001
            result_queue.put((ticket, ExceptionWrapper(e)))
