"""Sharded (per-shard-file) checkpointing (port of
paddle_tpu/distributed/checkpoint.py).

Reference roles:
  * framework/save_load_util.cc + save_combine/load_combine ops — binary
    tensor persistence for the trainer;
  * fleet sharding stage-3 checkpointing — every rank persists only the
    parameter/optimizer shards it owns.

The directory is the reference's layout byte for byte, so each package
reads the other's: every array leaf of the state tree is one ``.npy``
file per replica-0 shard, named by its index window (``_shard_fname``:
``leaf3.0-end_0-end.npy`` for a whole tensor, ``leaf7.0-512.npy`` for the
first of two ZeRO chunks, ``leaf9.scalar.npy``, ``leaf12.full.npy`` for a
host numpy leaf), plus a ``metadata.json`` skeleton with the tree, shapes,
dtype names and each shard's window, crc32 and byte count (taken from
the serialized bytes).  Each file is written to a tmp name, fsynced,
renamed and its directory fsynced; the metadata lands last, ``COMMIT``
after it once every shard re-reads intact.

A bf16 leaf is written as the reference's ``np.save`` of an ``ml_dtypes``
array writes it — descr ``'<V2'``, the 16-bit words — and recorded as
``"bfloat16"``; it reads back as ``torch.bfloat16`` without ``ml_dtypes``.
(The reference's own ``load_sharded`` cannot cast those ``V2`` words to
bfloat16 and raises on such a leaf.)

A tensor is one shard.  A :class:`ShardedLeaf` holds the windows of a
leaf this rank owns (the ZeRO step's flat moment chunks): with ``group``
given, each rank writes its own windows, rank 0 the replicated leaves and
the metadata, after the ranks' shard records are exchanged.  Loads read
only the requested window of each file (``np.load(mmap_mode="r")``).

Async saves snapshot every leaf to host memory at the call (a blocking
copy, complete before the caller's next step updates its parameters in
place) and write on a background thread behind an at-most-one-in-flight
fence; the files are the sync save's byte for byte.  An async save over
more than one rank raises: the writers' exchange would meet the ranks'
own collectives.
"""
from __future__ import annotations

import io
import json
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.framework import chaos, monitor
from paddle_tpu_torch.framework.observability import flight

__all__ = ["save_sharded", "load_sharded", "restore_like",
           "save_train_state", "load_train_state", "checkpoint_meta",
           "verify_checkpoint", "is_committed", "write_commit",
           "read_commit", "AsyncSaveHandle", "CheckpointVerifyError",
           "wait_pending_saves", "ShardedLeaf"]

_META = "metadata.json"
_COMMIT = "COMMIT"


class CheckpointVerifyError(RuntimeError):
    """A checkpoint directory failed integrity verification at a point
    where proceeding would persist or load corrupt state (save-side
    verify before commit).  Load-side verification never raises this —
    it falls back generation-by-generation instead."""


class ShardedLeaf:
    """The replica-0 windows of one leaf that this rank owns: the leaf's
    global ``shape`` and ``dtype`` and ``shards``, a list of (index, the
    tensor of that window), index a tuple of slices."""

    __slots__ = ("shape", "dtype", "shards")

    def __init__(self, shape, dtype, shards):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = list(shards)

    def to_host(self) -> "ShardedLeaf":
        return ShardedLeaf(self.shape, self.dtype,
                           [(i, _host_copy(t)) for i, t in self.shards])


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, complete on return."""
    return t.detach().to("cpu", copy=True)


def _dtype_name(dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).replace("torch.", "")


def _npy_parts(a):
    """(header, body) of the ``np.save`` stream of ``a`` (a tensor or a
    numpy value), the body a byte view of the array, not a copy; a bf16
    tensor as the reference writes an ``ml_dtypes`` one: descr '<V2'."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy()
            head = {"descr": "<V2", "fortran_order": False,
                    "shape": tuple(t.shape)}
        else:
            arr = t.numpy()
            head = np.lib.format.header_data_from_array_1_0(arr)
    else:
        arr = np.asarray(a)
        if not arr.flags.c_contiguous:
            arr = arr.copy()
        head = np.lib.format.header_data_from_array_1_0(arr)
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, head)
    return buf.getvalue(), arr.reshape(-1).view(np.uint8)


def _leafify(obj, leaves, path):
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic, ShardedLeaf)):
        idx = len(leaves)
        leaves.append((path, obj))
        return {"__leaf__": idx}
    if isinstance(obj, dict):
        return {str(k): _leafify(v, leaves, f"{path}/{k}") for k, v in
                obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_leafify(v, leaves, f"{path}/{i}") for i, v in
                enumerate(obj)]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"__const__": obj}
    raise TypeError(f"unsupported checkpoint node at {path}: {type(obj)}")


def _unleafify(skel, leaf_fn):
    if isinstance(skel, dict):
        if "__leaf__" in skel:
            return leaf_fn(skel["__leaf__"])
        if "__const__" in skel:
            return skel["__const__"]
        return {k: _unleafify(v, leaf_fn) for k, v in skel.items()}
    return [_unleafify(v, leaf_fn) for v in skel]


def _shard_fname(leaf_idx: int, index) -> str:
    parts = []
    for sl in index:
        parts.append(f"{sl.start or 0}-{sl.stop if sl.stop is not None else 'end'}")
    return f"leaf{leaf_idx}." + ("_".join(parts) or "scalar") + ".npy"


def _atomic_save(dirpath: str, fname: str, parts):
    """Crash-safe shard write of ``parts`` (:func:`_npy_parts`): the
    ``ckpt.save`` chaos point fires before the bytes land (a kill
    mid-save), and tmp+rename+dir-fsync means a torn write never leaves a
    half-written ``.npy`` under the final name.  Returns ``(crc32,
    nbytes)`` of the serialized stream — the stamp save_sharded records
    per shard, so verify_checkpoint can prove every byte landed intact."""
    chaos.fault_point("ckpt.save", meta={"file": fname})
    head, body = parts
    crc = zlib.crc32(body, zlib.crc32(head)) & 0xFFFFFFFF
    final = os.path.join(dirpath, fname)
    tmp = final + f".tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(head)
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        from paddle_tpu_torch.distributed.fleet.utils.fs import fsync_dir
        fsync_dir(dirpath)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return crc, len(head) + body.nbytes


def _window(index, shape):
    return [[sl.start or 0, sl.stop if sl.stop is not None else dim]
            for sl, dim in zip(index, shape)]


def _gather_objects(group, obj) -> list:
    """Every rank's ``obj`` in rank order (the loopback ranks' exchange,
    or ``all_gather_object`` over a process group)."""
    if group is None or group.size == 1:
        return [obj]
    if hasattr(group, "_ex"):
        return list(group._ex(group.rank, obj))
    import torch.distributed as dist
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.group)
    return out


def save_sharded(state: Any, dirpath: str, step: Optional[int] = None,
                 extra_meta: Optional[Dict[str, Any]] = None, group=None):
    """Write ``state`` (nested dict/list of tensors, numpy values and
    :class:`ShardedLeaf`) as a sharded checkpoint directory.  With
    ``group`` (the ranks' collective group) every rank calls this with
    its own state: each writes its :class:`ShardedLeaf` windows, rank 0
    the other leaves and, once every rank's records arrived, the
    metadata (last and atomically: its presence marks the shard set
    complete).  ``extra_meta`` (JSON-able) lands in metadata.json."""
    rank = 0 if group is None else group.rank
    os.makedirs(dirpath, exist_ok=True)
    leaves: list = []
    skel = _leafify(state, leaves, "")
    meta_leaves, mine = [], {}
    for i, (path, arr) in enumerate(leaves):
        if isinstance(arr, ShardedLeaf):
            rec_shards = []
            for index, data in arr.shards:
                fname = _shard_fname(i, index)
                crc, nbytes = _atomic_save(dirpath, fname, _npy_parts(data))
                rec_shards.append({"file": fname,
                                   "index": _window(index, arr.shape),
                                   "crc32": crc, "bytes": nbytes})
            mine[i] = rec_shards
            meta_leaves.append({"path": path, "shape": list(arr.shape),
                                "dtype": _dtype_name(arr.dtype),
                                "shards": None})
        elif isinstance(arr, torch.Tensor):
            index = (slice(None),) * arr.dim()
            fname = _shard_fname(i, index)
            rec = {"file": fname, "index": _window(index, arr.shape)}
            if rank == 0:
                crc, nbytes = _atomic_save(dirpath, fname, _npy_parts(arr))
                rec.update(crc32=crc, bytes=nbytes)
            meta_leaves.append({"path": path, "shape": list(arr.shape),
                                "dtype": _dtype_name(arr.dtype),
                                "shards": [rec]})
        else:
            a = np.asarray(arr)
            fname = f"leaf{i}.full.npy"
            rec = {"file": fname, "index": [[0, d] for d in a.shape]}
            if rank == 0:
                crc, nbytes = _atomic_save(dirpath, fname, _npy_parts(a))
                rec.update(crc32=crc, bytes=nbytes)
            meta_leaves.append({"path": path, "shape": list(a.shape),
                                "dtype": str(a.dtype), "shards": [rec]})
    everyone = _gather_objects(group, mine)
    if rank == 0:
        for i, rec in enumerate(meta_leaves):
            if rec["shards"] is None:
                rec["shards"] = [s for part in everyone
                                 for s in part.get(i, [])]
        meta = {"skeleton": skel, "leaves": meta_leaves, "step": step}
        if extra_meta:
            for k in ("skeleton", "leaves", "step"):
                if k in extra_meta:
                    raise ValueError(f"extra_meta may not shadow {k!r}")
            meta.update(extra_meta)
        chaos.fault_point("ckpt.save", meta={"file": _META})
        from paddle_tpu_torch.distributed.fleet.utils.fs import LocalFS
        LocalFS().atomic_write(os.path.join(dirpath, _META),
                               json.dumps(meta))
    _gather_objects(group, None)          # the metadata has landed


def checkpoint_meta(dirpath: str) -> Dict[str, Any]:
    """The checkpoint's non-tensor metadata (step, world_size, anything
    saved via ``extra_meta``) without touching a single shard file."""
    with open(os.path.join(dirpath, _META)) as f:
        meta = json.load(f)
    meta.pop("skeleton", None)
    meta.pop("leaves", None)
    return meta


# ---------------------------------------------------------------------------
# integrity: per-shard crc32 verification + commit markers
# ---------------------------------------------------------------------------

def verify_checkpoint(dirpath: str, deep: bool = True) -> List[dict]:
    """Integrity-check a checkpoint directory against its metadata.

    Returns a list of problem records (empty = verified): each names the
    offending ``file`` and a ``reason`` (``missing`` / ``truncated`` /
    ``crc_mismatch`` / ``no_metadata`` / ``bad_metadata`` /
    ``verify_error``).  ``deep=False`` skips the crc re-read (existence +
    size only).  Every detected corruption fires a ``ckpt.corrupt``
    flight event and counts ``ckpt_corrupt_total``.  The ``ckpt.verify``
    chaos point at the head models a broken verifier: an injected fault
    is counted (``ckpt_verify_errors_total``) and the checkpoint reported
    unverifiable (fail-closed), never silently trusted."""
    try:
        chaos.fault_point("ckpt.verify", meta={"dir": dirpath})
    except chaos.InjectedFault as e:
        monitor.stat_add("ckpt_verify_errors_total")
        flight.record("ckpt.verify_error", severity="warn",
                      dir=dirpath, error=repr(e))
        return [{"file": _META, "reason": "verify_error",
                 "detail": repr(e)}]
    problems: List[dict] = []
    meta_path = os.path.join(dirpath, _META)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        recs = meta["leaves"]
    except (OSError, ValueError, KeyError) as e:
        reason = "no_metadata" if not os.path.exists(meta_path) \
            else "bad_metadata"
        problems.append({"file": _META, "reason": reason,
                         "detail": repr(e)})
        _record_corruption(dirpath, problems)
        return problems
    for rec in recs:
        for sh in rec["shards"]:
            fpath = os.path.join(dirpath, sh["file"])
            try:
                size = os.path.getsize(fpath)
            except OSError:
                problems.append({"file": sh["file"], "reason": "missing",
                                 "leaf": rec["path"]})
                continue
            want_bytes = sh.get("bytes")
            if want_bytes is not None and size != want_bytes:
                problems.append({"file": sh["file"], "reason": "truncated",
                                 "leaf": rec["path"], "size": size,
                                 "expected": want_bytes})
                continue
            want_crc = sh.get("crc32")
            if deep and want_crc is not None:
                crc = 0
                try:
                    with open(fpath, "rb") as f:
                        while True:
                            chunk = f.read(1 << 20)
                            if not chunk:
                                break
                            crc = zlib.crc32(chunk, crc)
                except OSError as e:
                    problems.append({"file": sh["file"],
                                     "reason": "missing", "detail": repr(e),
                                     "leaf": rec["path"]})
                    continue
                if (crc & 0xFFFFFFFF) != want_crc:
                    problems.append({"file": sh["file"],
                                     "reason": "crc_mismatch",
                                     "leaf": rec["path"]})
            elif want_crc is None and want_bytes is None:
                # a stamp-less shard: the cheap check is that the npy
                # header still parses
                try:
                    a = np.load(fpath, mmap_mode="r")
                    del a
                except (OSError, ValueError) as e:
                    problems.append({"file": sh["file"],
                                     "reason": "truncated",
                                     "detail": repr(e),
                                     "leaf": rec["path"]})
    if problems:
        _record_corruption(dirpath, problems)
    return problems


def _record_corruption(dirpath: str, problems: List[dict]):
    monitor.stat_add("ckpt_corrupt_total")
    flight.record("ckpt.corrupt", severity="error", dir=dirpath,
                  files=[p["file"] for p in problems[:8]],
                  reasons=sorted({p["reason"] for p in problems}))


def write_commit(dirpath: str, generation: Optional[int] = None,
                 verify: bool = True):
    """Stamp a checkpoint directory COMMITTED — written strictly last,
    and (by default) only after every shard re-reads intact.  Raises
    :class:`CheckpointVerifyError` when verification fails (the save did
    not commit; the previous generation stands)."""
    if verify:
        problems = verify_checkpoint(dirpath)
        if problems:
            raise CheckpointVerifyError(
                f"refusing to commit {dirpath}: "
                + "; ".join(f"{p['file']}: {p['reason']}"
                            for p in problems[:4]))
    from paddle_tpu_torch.distributed.fleet.utils.fs import LocalFS
    LocalFS().atomic_write(
        os.path.join(dirpath, _COMMIT),
        json.dumps({"generation": generation, "time": time.time()}))


def read_commit(dirpath: str) -> Optional[dict]:
    """The directory's commit record, or None when uncommitted/torn."""
    try:
        with open(os.path.join(dirpath, _COMMIT)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_committed(dirpath: str) -> bool:
    return read_commit(dirpath) is not None


# ---------------------------------------------------------------------------
# reads
# ---------------------------------------------------------------------------

def _np_dtype(name: str):
    """The numpy dtype a leaf's words are read into (bf16: its uint16
    words)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _as_tensor(a: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _load_words(path: str, dt: np.dtype, mmap: bool = True):
    src = np.load(path, mmap_mode="r" if mmap else None)
    if src.dtype.kind == "V":                 # a '<V2' bf16 shard
        src = src.view(dt)
    return src


def _window_reader(dirpath: str, rec: dict) -> Callable:
    """cb(index) -> the tensor of that window of the leaf, read from the
    saved shard files, only their overlapping regions (mmap)."""
    shape = tuple(rec["shape"])
    name = rec["dtype"]
    dt = _np_dtype(name)

    def cb(index):
        want = tuple(
            slice(sl.start if sl.start is not None else 0,
                  sl.stop if sl.stop is not None else dim)
            for sl, dim in zip(index, shape))
        if not want:           # scalar
            f = rec["shards"][0]["file"]
            return _as_tensor(np.array(_load_words(
                os.path.join(dirpath, f), dt, mmap=False)), name)
        out = np.empty(tuple(w.stop - w.start for w in want), dt)
        for sh in rec["shards"]:
            lo = [a for a, _ in sh["index"]]
            hi = [b for _, b in sh["index"]]
            inter_lo = [max(w.start, a) for w, a in zip(want, lo)]
            inter_hi = [min(w.stop, b) for w, b in zip(want, hi)]
            if any(l >= h for l, h in zip(inter_lo, inter_hi)):
                continue
            src = _load_words(os.path.join(dirpath, sh["file"]), dt)
            src_sl = tuple(slice(l - a, h - a) for l, h, a in
                           zip(inter_lo, inter_hi, lo))
            dst_sl = tuple(slice(l - w.start, h - w.start) for l, h, w in
                           zip(inter_lo, inter_hi, want))
            out[dst_sl] = src[src_sl]
        return _as_tensor(out, name)
    return cb


def _whole(rec):
    return tuple(slice(0, d) for d in rec["shape"])


def load_sharded(dirpath: str, device="cpu"):
    """A checkpoint directory as the saved tree of tensors on ``device``
    (host tensors by default: the reference's numpy tree), each leaf
    assembled from its shard files."""
    with open(os.path.join(dirpath, _META)) as f:
        meta = json.load(f)
    recs = meta["leaves"]

    def leaf(i):
        return _window_reader(dirpath, recs[i])(_whole(recs[i])).to(device)
    return _unleafify(meta["skeleton"], leaf)


def restore_like(template: Any, dirpath: str):
    """Restore a checkpoint onto the layout of ``template``: leaves match
    by tree path; each loaded leaf lands on its template tensor's device
    (a :class:`ShardedLeaf` template reads only its windows, returned as
    a ShardedLeaf); the saved dtype is kept."""
    with open(os.path.join(dirpath, _META)) as f:
        meta = json.load(f)
    t_leaves: list = []
    _leafify(template, t_leaves, "")
    recs = meta["leaves"]
    if len(t_leaves) != len(recs):
        raise ValueError(
            f"template has {len(t_leaves)} leaves, checkpoint has "
            f"{len(recs)}")
    by_path = {tp: arr for tp, arr in t_leaves}
    for rec in recs:
        if rec["path"] not in by_path:
            raise ValueError(f"template/checkpoint tree mismatch: "
                             f"checkpoint leaf {rec['path']} not in "
                             f"template")

    def leaf(i):
        rec = recs[i]
        tarr = by_path[rec["path"]]
        cb = _window_reader(dirpath, rec)
        if isinstance(tarr, ShardedLeaf):
            return ShardedLeaf(rec["shape"], tarr.dtype, [
                (index, cb(index).to(t.device)) for index, t in tarr.shards])
        out = cb(_whole(rec))
        return out.to(tarr.device) if isinstance(tarr, torch.Tensor) \
            else out
    return _unleafify(meta["skeleton"], leaf)


# ---------------------------------------------------------------------------
# TrainStep-level convenience + async save tier
# ---------------------------------------------------------------------------

def _capture_train_state(step, global_step: Optional[int],
                         world_size: Optional[int]):
    """A TrainStep's state tree and extra metadata: the live tensors (a
    ZeRO step's moment chunks as :class:`ShardedLeaf` windows, its
    ``checkpoint_opt_states``)."""
    model = step.model
    opt_fn = getattr(step, "checkpoint_opt_states", None)
    opt_states = opt_fn() if callable(opt_fn) else (
        step._opt_states if step._opt_states is not None else {})
    # sorted, as the reference's jitted step returns its state dicts: the
    # leaves then take the reference's numbers and file names
    opt_states = {n: {k: opt_states[n][k] for k in sorted(opt_states[n])}
                  for n in sorted(opt_states)}
    state = {
        "params": {n: p.detach() for n, p in model.named_parameters()},
        "buffers": {n: b.detach() for n, b in model.named_buffers()
                    if b is not None},
        "opt_states": opt_states,
        "global_step": np.int64(global_step if global_step is not None
                                else step.optimizer._global_step),
    }
    extra: Dict[str, Any] = {}
    if world_size is not None:
        extra["world_size"] = int(world_size)
    meta_fn = getattr(step, "checkpoint_extra_meta", None)
    if callable(meta_fn):
        extra.update(meta_fn())
    return state, extra


def _snapshot_state(state):
    """Host-copy every leaf of a state tree at the step boundary: the
    copies are complete on return, so the next step's in-place update
    cannot reach the background writer's bytes."""
    if isinstance(state, dict):
        return {k: _snapshot_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_snapshot_state(v) for v in state)
    if isinstance(state, ShardedLeaf):
        return state.to_host()
    if isinstance(state, torch.Tensor):
        return _host_copy(state)
    if isinstance(state, np.ndarray):
        return state.copy()
    return state


class AsyncSaveHandle:
    """Handle to one in-flight background checkpoint write.

    ``wait()`` joins it and returns True when the write (and commit, if
    requested) landed; an exception in the writer thread re-raises there
    — never in the training thread that moved on."""

    def __init__(self):
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None
        self.committed = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not self._done.wait(timeout):
            raise TimeoutError("async checkpoint save still in flight")
        if self._exc is not None:
            raise self._exc
        return True

    def done(self) -> bool:
        return self._done.is_set()


class _AsyncSaver:
    """At-most-one-in-flight background checkpoint writer: submitting a
    new save first joins the previous one."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: Optional[threading.Thread] = None

    def submit(self, fn, handle: AsyncSaveHandle) -> AsyncSaveHandle:
        with self._lock:
            prev = self._inflight
            if prev is not None and prev.is_alive():
                prev.join()              # the at-most-one-in-flight fence

            def run():
                try:
                    fn()
                except BaseException as e:   # noqa: BLE001 — surfaced at wait()
                    handle._exc = e
                    flight.record("ckpt.async_error", severity="error",
                                  error=repr(e))
                    monitor.stat_add("ckpt_async_errors_total")
                finally:
                    handle._done.set()

            t = threading.Thread(target=run, name="ckpt-async-save",
                                 daemon=True)
            self._inflight = t
            t.start()
        return handle

    def wait_idle(self, timeout: Optional[float] = None):
        """Block until no save is in flight (shutdown / test fence)."""
        with self._lock:
            t = self._inflight
        if t is not None and t.is_alive():
            t.join(timeout)


_async_saver = _AsyncSaver()


def wait_pending_saves(timeout: Optional[float] = None):
    """Join any in-flight async checkpoint write — the process-exit /
    pre-restore fence."""
    _async_saver.wait_idle(timeout)


def _group_of(step):
    fn = getattr(step, "checkpoint_group", None)
    return fn() if callable(fn) else None


def save_train_state(step, dirpath: str, global_step: Optional[int] = None,
                     world_size: Optional[int] = None, mode: str = "sync",
                     commit: bool = False):
    """Persist a (ZeRO) TrainStep's full training state: parameters,
    buffers, optimizer slots and the global step.  ``world_size`` is
    recorded in the metadata (``checkpoint_meta``).  A ZeRO step
    (``parallel.zero.ShardedUpdateTrainStep``) writes each rank's moment
    chunks under their index windows and stamps its shard bookkeeping
    (``checkpoint_extra_meta``); every rank of it calls this.

    ``mode="async"``: snapshot to host memory now, write on a background
    thread behind an at-most-one-in-flight fence; returns an
    :class:`AsyncSaveHandle`.  The ``ckpt.async`` chaos point at the
    dispatch head degrades it to a counted sync save
    (``ckpt_async_fallbacks_total``, a ``ckpt.async_fallback`` flight
    event).  ``commit=True`` verifies every shard after the write and
    stamps the COMMIT marker (rank 0, strictly last)."""
    if mode not in ("sync", "async"):
        raise ValueError(f"unknown save mode {mode!r}")
    group = _group_of(step)
    if mode == "async" and group is not None and group.size > 1:
        raise ValueError(
            "save_train_state(mode='async') over more than one rank: the "
            "background writers' exchange would meet the ranks' own "
            "collectives; save with mode='sync'")
    state, extra = _capture_train_state(step, global_step, world_size)

    def write(st):
        save_sharded(st, dirpath, step=global_step,
                     extra_meta=extra or None, group=group)
        if commit and (group is None or group.rank == 0):
            write_commit(dirpath, generation=global_step)
        _gather_objects(group, None)

    if mode == "async":
        snap = _snapshot_state(state)
        try:
            chaos.fault_point("ckpt.async", meta={"dir": dirpath})
            handle = AsyncSaveHandle()
            out = _async_saver.submit(lambda: write(snap), handle)
            out.committed = commit
            return out
        except chaos.InjectedFault as e:
            monitor.stat_add("ckpt_async_fallbacks_total")
            flight.record("ckpt.async_fallback", severity="warn",
                          dir=dirpath, error=repr(e))
            state = snap             # fall through to the sync path
    write(state)
    return None


def _assign(dst: torch.Tensor, src: torch.Tensor):
    with torch.no_grad():
        dst.copy_(src.to(dst.device))


def load_train_state(step, dirpath: str):
    """Restore into a live (ZeRO) TrainStep, in place: each parameter and
    buffer takes the saved values (cast to its dtype, on its device), the
    optimizer state is the saved one on the parameters' device.

    ZeRO interop, both ways: a step with ``load_checkpoint_state`` (the
    ZeRO step) adopts the checkpoint itself, moments saved at any dp or by
    a replicated step resharded onto its own; a replicated step restoring
    a ZeRO checkpoint gets the flat padded moments cut back to each
    parameter's shape."""
    meta = checkpoint_meta(dirpath)
    zmeta = meta.get("zero")
    hook = getattr(step, "load_checkpoint_state", None)
    if callable(hook):
        return hook(load_sharded(dirpath), zmeta)
    if zmeta:
        return _load_zero_into_replicated(step, dirpath, zmeta)
    model = step.model
    named_params = dict(model.named_parameters())
    named_buffers = {n: b for n, b in model.named_buffers() if b is not None}
    if step._opt_states is None:
        step._opt_states = step.optimizer.functional_init_states(
            {n: p.detach() for n, p in named_params.items()
             if p.requires_grad})
    template = {
        "params": {n: p.detach() for n, p in named_params.items()},
        "buffers": {n: b.detach() for n, b in named_buffers.items()},
        "opt_states": step._opt_states,
        "global_step": np.int64(0),
    }
    state = restore_like(template, dirpath)
    for n, p in named_params.items():
        _assign(p, state["params"][n])
    for n, b in named_buffers.items():
        _assign(b, state["buffers"][n])
    step._opt_states = state["opt_states"]
    step.optimizer._global_step = int(state["global_step"])
    return state


def _load_zero_into_replicated(step, dirpath: str, zmeta: dict):
    """A ZeRO checkpoint into a plain TrainStep: the moments were saved
    as dp-padded flat vectors — each is cut back to its logical size
    (the ``zero`` bookkeeping) and reshaped to its parameter's shape;
    scalars pass through."""
    model = step.model
    state = load_sharded(dirpath)
    named_params = dict(model.named_parameters())
    sizes = {n: rec["size"] for n, rec in zmeta.get("leaves", {}).items()}
    for n, p in named_params.items():
        _assign(p, state["params"][n])
    for n, b in model.named_buffers():
        if b is not None and n in state.get("buffers", {}):
            _assign(b, state["buffers"][n])
    opt_states = {}
    for n, slots in (state.get("opt_states") or {}).items():
        if n not in named_params:
            raise ValueError(f"checkpoint moment {n!r} has no matching "
                             "parameter")
        p = named_params[n]
        out = {}
        for k, v in slots.items():
            if v.dim() == 0:
                out[k] = v.to(p.device)
                continue
            flat = v.reshape(-1)[:sizes.get(n, p.numel())]
            out[k] = flat.reshape(p.shape).to(p.device)
        opt_states[n] = out
    step._opt_states = opt_states
    step.optimizer._global_step = int(state.get("global_step", 0))
    return state
