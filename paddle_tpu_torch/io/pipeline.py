"""Streaming ingest plane (port of paddle_tpu/io/pipeline.py): pipelined
decode, double-buffered device transfer, and a decoded-sample cache.

The dense file-fed path was the one tier without a real pipeline: the
loader decoded JPEGs inline on the consumer thread, the device copy
blocked the step, and epoch 2 re-paid every decode epoch 1 already did
(BENCH_r05: 98.98% input stall on the filefed leg).  This module is the
production rebuild, three stages behind one iterator:

* **decode+collate** — owned by the :class:`~paddle_tpu_torch.io.DataLoader`
  (process workers with ``collate_in_worker=True`` decode, augment AND
  collate at batch granularity, shipping one contiguous numpy array per
  field — no per-sample pickling, never a per-sample device tensor);
* **transfer** — :class:`IngestPipeline` runs ``fetch(N+1)`` and the
  copy of batch N+1 to the card on a background executor while the card
  runs the step on batch N (:func:`to_device`: pinned host memory, a
  ``non_blocking`` copy on a side CUDA stream, an event the consumer's
  stream waits on at the hand-off) — the same deferred-executor idiom as
  ``PSTrainStep.prefetch`` (pull/compute overlap), with the same
  ``flush()``/early-exit contract and a ``data.pipeline`` chaos point
  at the head of every background task;
* **cache** — :class:`SampleCache`/:class:`CachedDataset`: an opt-in,
  byte-bounded decoded-sample cache (in-RAM dict or one crash-safe
  tmp+rename file per sample) recorded during epoch 1 so epoch >= 2
  skips JPEG decode entirely — what actually kills the stall on
  core-starved hosts.

Every stage is instrumented with the PR-5 observability plane: a tracer
span per stage (``ingest.fetch`` wrapping each batch's producer task,
``ingest.decode``, ``ingest.transfer``, ``ingest.wait``) — each yielded
batch additionally declares a causal ``ingest`` link
(``Tracer.link_next``) that the consuming train step's span adopts, so
``framework/blame.py`` can attribute input stalls to ``ingest_wait`` —
per-stage time histograms (``ingest_decode_ms``, ``ingest_collate_ms``,
``ingest_transfer_ms``, ``ingest_wait_ms``), cache hit/miss counters,
and ``input_stall_pct`` as a first-class exported gauge
(``monitor.export_prometheus()``) instead of a bench-only number.

**Ordering/parity contract** (the PR-4 discipline): the pipelined stream
is byte-identical to the plain sequential loader's — order, values,
dtypes — for a fixed seed.  Fetches are sequence-stamped under one lock,
the consumer reorders by stamp, and an injected ``data.pipeline`` fault
degrades that one batch to a synchronous fetch+transfer on the consumer
thread: no sample lost, none duplicated.  Combined with
``DistributedBatchSampler.reshard`` (sample assignment derived from
``(rank, nranks, membership_epoch)`` over the unconsumed suffix of a
membership-independent epoch order), a mid-epoch ``elastic.reform()``
re-shards deterministically: ``flush()`` the pipeline, ``reshard`` the
sampler, re-enter — prefetched-but-unconsumed batches sit beyond the
consumed cursor and are simply re-yielded under the new membership.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
import time
import warnings
from collections import deque
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from paddle_tpu_torch.framework import chaos, health, locks, monitor
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.io import Dataset

__all__ = ["IngestPipeline", "SampleCache", "CachedDataset", "to_device"]


class _Landing:
    """A batch whose copies to the card were issued on a side stream:
    ``event`` completes when they have landed."""

    __slots__ = ("batch", "event")

    def __init__(self, batch, event):
        self.batch = batch
        self.event = event


def _map_arrays(batch, fn):
    if isinstance(batch, torch.Tensor):
        return batch
    if isinstance(batch, np.ndarray):
        return fn(batch)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_arrays(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_arrays(v, fn) for k, v in batch.items()}
    return batch


def _tensors(batch):
    if isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, (list, tuple)):
        for b in batch:
            yield from _tensors(b)
    elif isinstance(batch, dict):
        for v in batch.values():
            yield from _tensors(v)


_side_streams: dict = {}
_side_lock = threading.Lock()


def _side_stream(device: torch.device):
    with _side_lock:
        s = _side_streams.get(device.index)
        if s is None:
            s = _side_streams[device.index] = torch.cuda.Stream(device)
        return s


def to_device(batch, device=None):
    """Default transfer stage: every numpy array in ``batch`` becomes a
    tensor on ``device`` (the port's default device when None), one copy
    per FIELD; nested lists/tuples/dicts map through, tensors pass
    untouched.  On the CPU the tensor shares the array's memory.  On the
    card each array goes through pinned host memory to a ``non_blocking``
    copy issued on a side stream (the calling thread selects the device
    itself), and the result is a :class:`_Landing` carrying the event the
    copies complete on: :func:`land` makes the consumer's stream wait on
    it before the batch is used."""
    from paddle_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return _map_arrays(batch, lambda a: torch.from_numpy(
            np.ascontiguousarray(a)))
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.device(dev):
        stream = _side_stream(dev)
        with torch.cuda.stream(stream):
            out = _map_arrays(batch, lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).pin_memory().to(
                    dev, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
    return _Landing(out, event)


def land(batch):
    """The consumer's side of :func:`to_device`: its current stream waits
    on the copies' event, and each tensor is recorded on that stream so
    the caching allocator does not hand its memory out again while the
    consumer's work on it is queued.  Anything else passes through."""
    if not isinstance(batch, _Landing):
        return batch
    out = batch.batch
    tensors = list(_tensors(out))
    if tensors:
        with torch.cuda.device(tensors[0].device):
            consumer = torch.cuda.current_stream()
            consumer.wait_event(batch.event)
            for t in tensors:
                t.record_stream(consumer)
    return out


def _nbytes(sample) -> int:
    if isinstance(sample, _Landing):
        return _nbytes(sample.batch)
    if isinstance(sample, np.ndarray):
        return sample.nbytes
    if isinstance(sample, torch.Tensor):
        return sample.numel() * sample.element_size()   # device ones too
    if isinstance(sample, (list, tuple)):
        return sum(_nbytes(s) for s in sample)
    if isinstance(sample, dict):
        return sum(_nbytes(v) for v in sample.values())
    return 16                                   # scalar/str: nominal


class SampleCache:
    """Bounded decoded-sample cache — epoch 1 records, epoch >= 2 hits.

    ``mode``: ``"memory"`` (in-RAM dict, single-process), ``"disk"``
    (one file per sample under ``cache_dir``, written crash-safely via
    the fs tier's tmp+rename helper so a kill mid-insert leaves either
    no file or a whole one — and shared across DataLoader worker
    processes), or ``""``/None to read ``FLAGS_ingest_cache_mode``.
    Inserts stop once recorded payload bytes reach ``max_bytes``
    (``FLAGS_ingest_cache_bytes``), so a cache can never eat the host;
    lookups past the bound simply miss.

    Hit/miss totals land in the monitor registry
    (``ingest_cache_hits_total`` / ``ingest_cache_misses_total``) so
    they export through ``monitor.export_prometheus()``.  When the
    cache runs inside DataLoader *worker processes* (disk mode), each
    child counts into its own registry — the parent's
    ``export_prometheus()`` reflects only parent-side lookups; and the
    byte bound is enforced per process against the shared directory's
    measured size (resynced every :data:`_RESYNC_EVERY` inserts), so
    concurrent workers can overshoot ``max_bytes`` by at most one
    resync window, never by a factor of the worker count.

    A disk directory is stamped with the dataset's fingerprint (type
    name + length) the first time a :class:`CachedDataset` binds it —
    rebinding a dir recorded for a different dataset raises instead of
    silently serving the old samples.  (Same-shaped different *content*
    — e.g. regenerated files, a changed pre-cache transform — is not
    detectable; point ``cache_dir`` somewhere fresh or :meth:`clear`
    when the source changes.)
    """

    _RESYNC_EVERY = 64          # disk puts between directory re-scans

    def __init__(self, mode: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        self.mode = str(flag("ingest_cache_mode")) if mode is None else mode
        if self.mode not in ("", "memory", "disk"):
            raise ValueError(
                f"ingest cache mode must be '', 'memory' or 'disk' — "
                f"got {self.mode!r}")
        self.cache_dir = cache_dir or str(flag("ingest_cache_dir")) \
            or os.path.join(os.getcwd(), "ingest_cache")
        self.max_bytes = int(flag("ingest_cache_bytes")) \
            if max_bytes is None else int(max_bytes)
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self._mem: dict = {}
        self._puts = 0
        self._lock = locks.lock("ingest.cache")

    @property
    def enabled(self) -> bool:
        return self.mode in ("memory", "disk")

    def _disk_path(self, key) -> str:
        return os.path.join(self.cache_dir, f"s{key}.pkl")

    def _disk_dir_bytes(self) -> int:
        try:
            with os.scandir(self.cache_dir) as it:
                return sum(e.stat().st_size for e in it
                           if e.name.startswith("s")
                           and e.name.endswith(".pkl"))
        except OSError:
            return 0

    def bind(self, dataset):
        """Stamp a disk cache dir with ``dataset``'s fingerprint (type
        name + length, crash-safe write); raise if the dir was recorded
        for a different dataset — a stale cache must fail loudly, not
        serve the previous run's samples."""
        if self.mode != "disk":
            return
        fp = f"{type(dataset).__name__}:{len(dataset)}"
        meta = os.path.join(self.cache_dir, "meta.json")
        os.makedirs(self.cache_dir, exist_ok=True)
        try:
            with open(meta) as f:
                recorded = json.load(f).get("fingerprint")
            if recorded != fp:
                raise ValueError(
                    f"stale decoded-sample cache: {self.cache_dir!r} "
                    f"was recorded for {recorded!r}, now binding "
                    f"{fp!r} — clear() it or point "
                    f"FLAGS_ingest_cache_dir somewhere fresh")
            return
        except (OSError, json.JSONDecodeError):
            pass                                 # unstamped dir: stamp it
        from paddle_tpu_torch.distributed.fleet.utils.fs import LocalFS
        try:
            LocalFS().atomic_write(
                meta, json.dumps({"fingerprint": fp}).encode())
        except OSError:
            pass                # unstampable (read-only dir): best effort

    def get(self, key) -> Optional[Any]:
        """The cached sample for ``key``, or None on a miss."""
        if not self.enabled:
            return None
        if self.mode == "memory":
            with self._lock:
                sample = self._mem.get(key)
        else:
            try:
                with open(self._disk_path(key), "rb") as f:
                    sample = pickle.load(f)
            except (OSError, pickle.PickleError, EOFError):
                sample = None
        if sample is None:
            self.misses += 1
            monitor.stat_add("ingest_cache_misses_total")
            return None
        self.hits += 1
        monitor.stat_add("ingest_cache_hits_total")
        return sample

    def put(self, key, sample) -> bool:
        """Record ``sample`` under ``key``; False when the byte bound is
        reached (the cache stays a bounded accelerator, not a spill)."""
        if not self.enabled:
            return False
        if self.mode == "memory":
            size = _nbytes(sample)
            with self._lock:
                if key in self._mem:
                    return True
                if self.bytes_used + size > self.max_bytes:
                    return False
                self._mem[key] = sample
                self.bytes_used += size
            return True
        blob = pickle.dumps(sample, protocol=4)
        with self._lock:
            # the directory is shared (across processes in worker mode):
            # periodically re-measure it so every process enforces the
            # bound against the TOTAL payload, not its own inserts
            if self._puts % self._RESYNC_EVERY == 0:
                self.bytes_used = self._disk_dir_bytes()
            self._puts += 1
            if self.bytes_used + len(blob) > self.max_bytes:
                return False
            self.bytes_used += len(blob)
        from paddle_tpu_torch.distributed.fleet.utils.fs import LocalFS
        os.makedirs(self.cache_dir, exist_ok=True)
        try:
            LocalFS().atomic_write(self._disk_path(key), blob)
        except OSError:
            return False                # full disk: cache off, train on
        return True

    def clear(self):
        with self._lock:
            self._mem.clear()
            self.bytes_used = 0
            self._puts = 0
        if self.mode == "disk" and os.path.isdir(self.cache_dir):
            for name in os.listdir(self.cache_dir):
                if name == "meta.json" or (name.startswith("s")
                                           and name.endswith(".pkl")):
                    try:
                        os.unlink(os.path.join(self.cache_dir, name))
                    except OSError:
                        pass

    # pickling (DataLoader spawn workers get the dataset by value): the
    # lock is recreated; a memory cache arrives EMPTY in the child —
    # only the disk mode is shared across worker processes
    def __getstate__(self):
        d = self.__dict__.copy()
        d["_lock"] = None
        if self.mode == "memory":
            warnings.warn(
                "SampleCache(mode='memory') is crossing a process "
                "boundary (DataLoader process workers?): it arrives "
                "EMPTY in the child and worker-side inserts never "
                "return, so the epoch>=2 decode skip will not happen — "
                "use mode='disk' to share a cache across worker "
                "processes", RuntimeWarning, stacklevel=2)
            d["_mem"] = {}
            d["bytes_used"] = 0
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = locks.lock("ingest.cache")
        self._puts = 0          # fresh process: resync on first put


class CachedDataset(Dataset):
    """Wrap ``dataset`` with a :class:`SampleCache`: the first access to
    index ``i`` (epoch 1) pays the full ``dataset[i]`` — JPEG decode,
    resize — and records the result; later epochs hit the cache and
    skip decode entirely.  ``transform`` (optional) is applied AFTER
    the cache on every access, so live augmentation stays live while
    only the expensive decoded tensor is frozen."""

    def __init__(self, dataset, cache: SampleCache,
                 transform: Optional[Callable] = None):
        self.dataset = dataset
        self.cache = cache
        self.transform = transform
        cache.bind(dataset)     # disk mode: refuse a stale directory

    def __getitem__(self, i):
        sample = self.cache.get(i)
        if sample is None:
            sample = self.dataset[i]
            self.cache.put(i, sample)
        return self.transform(sample) if self.transform is not None \
            else sample

    def __len__(self):
        return len(self.dataset)


_DONE = object()      # background fetch hit the end of the stream
_FAULTED = object()   # injected data.pipeline fault: loader untouched


class IngestPipeline:
    """Double-buffered host->device ingest over any batch iterable.

    Wraps a loader (normally a :class:`~paddle_tpu_torch.io.DataLoader` with
    ``collate_in_worker=True`` yielding contiguous numpy batches) and
    yields device batches, with fetch(N+1) and its copy to the device
    running on a background executor while the caller's step consumes
    batch N — the ``PSTrainStep.prefetch`` deferred-executor idiom
    applied to the input side::

        pipe = IngestPipeline(loader)
        for xb, yb in pipe:          # device tensors, loader order
            loss = step(xb, yb)
        # pipe.input_stall_pct, monitor.get_stat("input_stall_pct")

    ``prefetch_depth`` (``FLAGS_ingest_prefetch_depth``) bounds the
    in-flight batches; 0 disables the overlap (synchronous
    fetch+transfer, still instrumented), 1 is the classic double
    buffer.  ``transfer`` replaces the default :func:`to_device` stage;
    ``device`` is the default stage's device (the port's default device
    when None).
    ``timeout`` (seconds) bounds the consumer's wait on a background
    batch; the loader's own ``timeout=`` still governs its workers.

    **Fault contract** — every background task fires the
    ``data.pipeline`` chaos point first.  ``mode="error"`` degrades
    that one batch to a synchronous fetch+transfer on the consumer
    thread (the loader iterator was not advanced, so it is the SAME
    batch: no sample lost, none duplicated — fetches are
    sequence-stamped under one lock and the consumer reorders by
    stamp); ``mode="latency"`` is a slow decode the wait stage simply
    absorbs.  Any real exception from the loader (worker death, decode
    error, loader timeout) propagates to the consumer after the
    pipeline drains.

    **Early exit / elastic** — breaking out of the iterator flushes the
    background work (generator finalizer); :meth:`flush` is the
    explicit form, the barrier to run before a mid-epoch
    ``elastic.reform()``: flush, ``sampler.reshard(...)``, re-enter.
    Prefetched-but-unconsumed batches are beyond the sampler's consumed
    cursor, so the re-formed iteration re-yields exactly them.
    """

    def __init__(self, loader: Iterable,
                 prefetch_depth: Optional[int] = None,
                 transfer: Optional[Callable] = None,
                 timeout: Optional[float] = None,
                 tracer=None, device=None):
        self.loader = loader
        self.prefetch_depth = int(flag("ingest_prefetch_depth")) \
            if prefetch_depth is None else int(prefetch_depth)
        self.transfer = transfer or (lambda b: to_device(b, device))
        self.timeout = timeout
        self._tracer = tracer
        # lifetime stats (across epochs/iterations)
        self.batches = 0
        self.wait_ms_total = 0.0
        self.downstream_ms_total = 0.0
        self._active = None          # the live _Iteration, for flush()

    def tracer(self):
        if self._tracer is not None:
            return self._tracer
        from paddle_tpu_torch.framework import observability
        return observability.tracer

    # -- stall accounting ---------------------------------------------------
    @property
    def input_stall_pct(self) -> float:
        """Share of consumer wall time spent blocked on input: wait /
        (wait + downstream compute), over this pipeline's lifetime."""
        total = self.wait_ms_total + self.downstream_ms_total
        return 100.0 * self.wait_ms_total / total if total > 0 else 0.0

    def _note_wait(self, wait_ms: float):
        self.wait_ms_total += wait_ms
        monitor.observe("ingest_wait_ms", wait_ms)
        monitor.stat_set("input_stall_pct", self.input_stall_pct)
        health.observe("input_stall_pct", self.input_stall_pct)

    def _note_batch(self):
        self.batches += 1
        monitor.stat_add("ingest_batches_total")

    # -- stage instrumentation ----------------------------------------------
    @staticmethod
    def _observe_stage_ms(stage, fetch_ms: float):
        """Per-stage decode/collate histograms.  A worker-collate
        DataLoader measured the stages inside the worker
        (``last_stage_ms``, snapshotted by the caller under the fetch
        lock — a concurrent fetch overwrites it); otherwise the whole
        fetch is decode."""
        monitor.observe("ingest_decode_ms",
                        stage.get("decode_ms", fetch_ms))
        monitor.observe("ingest_collate_ms", stage.get("collate_ms", 0.0))

    def _fetch_transfer(self, it, lock, seq_box):
        """One sequence-stamped fetch + device transfer.  Runs on the
        background executor (pipelined) or inline on the consumer
        thread (sync path / fault fallback); the lock serializes the
        loader iterator and the stamp, so concurrent callers can never
        skip or duplicate a batch."""
        tr = self.tracer()
        with lock:
            seq = seq_box[0]
            with tr.start_span("ingest.decode", consume_links=False):
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return _DONE
                fetch_ms = (time.perf_counter() - t0) * 1e3
            stage = dict(getattr(self.loader, "last_stage_ms", None) or {})
            seq_box[0] += 1
        self._observe_stage_ms(stage, fetch_ms)
        with tr.start_span("ingest.transfer", consume_links=False):
            t0 = time.perf_counter()
            dev = self.transfer(batch)
            monitor.observe("ingest_transfer_ms",
                            (time.perf_counter() - t0) * 1e3)
        if int(flag("health_mem_sample_every")) > 0:
            # attribute the in-flight device batch to the ingest tag
            # (sizes only — no device sync); same switch as
            # the TrainStep memory hook, so the tags snapshot and the
            # live/peak gauges it annotates turn on together
            health.memory.track("ingest", _nbytes(dev))
        return seq, dev

    def _task(self, it, lock, seq_box, chaos_gate: bool = True):
        """One producer unit — chaos gate (background tasks only), then
        fetch+transfer — the whole thing under a detached
        ``ingest.fetch`` producer span (the gate is INSIDE the span, so
        injected ``data.pipeline`` latency widens the producer and
        blame sees it as ``ingest_wait``).  The gate fires BEFORE the
        loader is touched, so an injected error leaves the iterator
        un-advanced and the consumer's synchronous fallback — this same
        method with ``chaos_gate=False``, the fallback must not re-trip
        the fault — fetches the exact batch this task would have.
        Returns ``(seq, device_batch, producer_span_id)`` — the span id
        is what the yield hand-off links into the consuming step."""
        tr = self.tracer()
        sp = tr.start_span("ingest.fetch", detached=True)
        try:
            if chaos_gate:
                try:
                    chaos.fault_point("data.pipeline",
                                      meta={"seq": seq_box[0]})
                except chaos.InjectedFault:
                    sp.end(status="error", reason="chaos_fault")
                    return _FAULTED
            with tr.activate(sp.context()):
                got = self._fetch_transfer(it, lock, seq_box)
        except BaseException as e:
            sp.end(status="error", exc=repr(e))
            raise
        if got is _DONE:
            sp.end(status="ok", eos=True)
            return _DONE
        sp.end(status="ok", seq=got[0])
        return (got[0], got[1], sp.span_id)

    # -- iteration ----------------------------------------------------------
    def __iter__(self):
        if self.prefetch_depth <= 0:
            yield from self._iter_sync()
            return
        yield from self._iter_pipelined()

    def _iter_sync(self):
        it = iter(self.loader)
        lock, seq_box = locks.lock("ingest.fetch"), [0]
        tr = self.tracer()
        t_ret = None
        while True:
            if t_ret is not None:
                self.downstream_ms_total += \
                    (time.perf_counter() - t_ret) * 1e3
            t0 = time.perf_counter()
            got = self._task(it, lock, seq_box, chaos_gate=False)
            if got is _DONE:
                return
            self._note_wait((time.perf_counter() - t0) * 1e3)
            self._note_batch()
            t_ret = time.perf_counter()
            if got[2] is not None:
                # hand-off: the next span the consumer opens (its
                # train step) causally links this batch's fetch
                tr.link_next(got[2], "ingest")
            yield land(got[1])

    def _iter_pipelined(self):
        from concurrent.futures import ThreadPoolExecutor
        it = iter(self.loader)
        lock, seq_box = locks.lock("ingest.fetch"), [0]
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="ingest")
        inflight: deque = deque()
        state = {"pool": pool, "inflight": inflight, "it": it,
                 "drain_timeout": self.timeout or 30.0}
        self._active = state
        tr = self.tracer()
        expected = 0                  # next sequence stamp to yield
        ready: dict = {}              # seq -> device batch (reordering)
        exhausted = False
        t_ret = None
        try:
            while True:
                while not exhausted and \
                        len(inflight) < self.prefetch_depth:
                    inflight.append(pool.submit(
                        self._task, it, lock, seq_box))
                if t_ret is not None:
                    self.downstream_ms_total += \
                        (time.perf_counter() - t_ret) * 1e3
                    t_ret = None
                while expected not in ready:
                    if not inflight:
                        if exhausted:
                            return
                        raise RuntimeError(
                            "ingest pipeline wedged: nothing in flight "
                            f"while waiting for batch {expected}")
                    fut = inflight.popleft()
                    with tr.start_span("ingest.wait",
                                       consume_links=False):
                        t0 = time.perf_counter()
                        try:
                            got = fut.result(timeout=self.timeout)
                        except FuturesTimeout:
                            raise RuntimeError(
                                f"ingest pipeline timed out after "
                                f"{self.timeout}s waiting for batch "
                                f"{expected}") from None
                        self._note_wait(
                            (time.perf_counter() - t0) * 1e3)
                    if got is _DONE:
                        exhausted = True
                    elif got is _FAULTED:
                        # degraded batch: same-stream synchronous
                        # fetch+transfer (see class docstring)
                        monitor.stat_add("ingest_prefetch_misses_total")
                        got = self._task(it, lock, seq_box,
                                         chaos_gate=False)
                        if got is _DONE:
                            exhausted = True
                        else:
                            ready[got[0]] = (got[1], got[2])
                    else:
                        monitor.stat_add("ingest_prefetch_hits_total")
                        ready[got[0]] = (got[1], got[2])
                dev, producer_sid = ready.pop(expected)
                expected += 1
                self._note_batch()
                t_ret = time.perf_counter()
                if producer_sid is not None:
                    # hand-off: the next span the consumer opens (its
                    # train step) causally links this batch's fetch —
                    # the edge blame walks to attribute ingest stalls
                    tr.link_next(producer_sid, "ingest")
                yield land(dev)
        finally:
            self._active = None
            self._flush_state(state)

    # -- flush / early-exit contract ----------------------------------------
    @staticmethod
    def _flush_state(state):
        inflight, pool = state["inflight"], state["pool"]
        for fut in inflight:
            fut.cancel()
        drained = True
        for fut in inflight:
            if not fut.cancelled():
                try:
                    fut.result(timeout=state["drain_timeout"])
                except FuturesTimeout:
                    drained = False     # fetch thread still in the loader
                except Exception:       # noqa: BLE001 — draining only
                    pass
        inflight.clear()
        pool.shutdown(wait=False)
        if not drained:
            # a background fetch is wedged inside the loader: the
            # iterator generator is mid-execution (close() would raise
            # 'generator already executing') and the thread may still
            # touch the loader — the barrier cannot settle, so fail
            # loudly instead of letting a reform race the loader
            raise RuntimeError(
                "ingest flush timed out: a background fetch is still "
                f"running after {state['drain_timeout']}s — the loader "
                "is wedged (dead worker? hung decode?); tear it down "
                "instead of re-entering")
        close = getattr(state["it"], "close", None)
        if close is not None:
            try:
                close()
            except ValueError:
                # 'generator already executing': a fetch thread is in
                # its last instants inside the loader (woke up between
                # the drain and here, or a re-entrant flush during
                # generator finalization) — it no longer has a future
                # to deliver to, so abandoning the close is safe
                pass

    def flush(self):
        """Settle all background work (the ``PSTrainStep.flush``
        contract): cancel queued tasks, drain running ones, close the
        loader iterator.  The barrier before a mid-epoch
        ``elastic.reform()``/``sampler.reshard`` — after it, no
        background thread touches the loader, and every un-yielded
        batch is still unconsumed from the sampler's point of view."""
        state = self._active
        self._active = None
        if state is not None:
            self._flush_state(state)
