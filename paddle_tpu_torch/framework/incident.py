"""Postmortem plane: incident capture bundles and deterministic replay
(port of paddle_tpu/framework/incident.py).

A ``train.nan_skip`` names the first bad leaf, a ``parity.divergence``
the first divergent one, the autopilot records what it did; then the
step's inputs, random state and pre-step state are gone.  This module
keeps them:

* **ring**: with ``FLAGS_incident`` armed, :func:`maybe_note` (hooked at
  the head of ``ResilientTrainStep`` and ``PSTrainStep``) keeps the last
  ``FLAGS_incident_ring`` steps' host copies of the step inputs (batch
  tensors or the PS pulled-row ids), the random state (the default
  generator of the step's device and of the CPU, and any generator given
  to :func:`track_generator`: pure reads, the streams are not moved),
  the chaos registry's schedule (:func:`chaos.arm_state`) and the
  pre-step training state (parameters, buffers, optimizer state and
  global step copied to the host).  Host-only reads: the armed
  trajectory is bitwise the disarmed one, and disarmed the hook is one
  flag lookup.

* **capture**: a subscribed flight kind firing (``FLAGS_incident_kinds``;
  the default :data:`DEFAULT_KINDS`) writes a crash-safe bundle under
  ``FLAGS_incident_dir``: the input ring, the oldest entry's pre-step
  state inline when it is at most ``FLAGS_incident_state_cap_mb``
  (else a ``{root, generation}`` reference to the verified generation
  of the step's durable ``CheckpointManager`` saved at the ring's first
  step), the flag
  overrides, the chaos schedule, ``monitor.snapshot()``, the flight tail,
  the blame split when a tracer is live, and per-step trajectory hashes
  (``parity.leaf_hash_host``) for the first-divergence bisection.  Every
  file lands tmp + rename with a crc32 stamp, and the ``COMMIT`` marker
  is written last: :func:`verify_bundle` refuses a torn directory.  The
  files, stamps and marker are the reference's: each package's
  :func:`verify_bundle` accepts the other's bundle.  The triggering event
  is stamped with the bundle's ``incident`` id, a ``kind=incident`` run
  ledger record indexes it, and a bounded notice queue feeds the
  collector push.  Capture never raises (the ``incident.capture`` chaos
  point and ``incident_capture_errors_total``).

* **replay**: ``python -m paddle_tpu_torch.tools.replay <bundle>``
  restores the recorded state, re-arms the flags and the chaos schedule,
  re-feeds the ringed inputs through the step and checks that the
  recorded signal comes back (the same ``first_bad_leaf``); ``--bisect``
  re-runs with chaos disarmed and walks the trajectory hashes to the
  first step whose clean re-run diverges.

The random state is PyTorch's generator state (a uint8 vector), not the
reference's key: a bundle's ``rng`` files replay in the package that
wrote them.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.framework import chaos, monitor
from paddle_tpu_torch.framework.flags import flag

__all__ = ["DEFAULT_KINDS", "enabled", "subscribed_kinds", "incident_dir",
           "IncidentRecorder", "recorder", "maybe_note", "install",
           "uninstall", "set_program", "reset", "verify_bundle",
           "read_manifest", "load_ring_entry", "state_tree_of_prestate",
           "hash_state_tree", "hash_step_state", "drain_notices",
           "train_surface", "whole_params", "track_generator",
           "restore_rng",
           "BUNDLE_PREFIX", "MANIFEST_NAME", "COMMIT_NAME"]

SCHEMA_VERSION = 1
BUNDLE_PREFIX = "incident_"
MANIFEST_NAME = "manifest.json"
COMMIT_NAME = "COMMIT"
STATE_DIRNAME = "state"

#: the built-in subscription: every plane that names a step, a leaf or an
#: action worth reproducing
DEFAULT_KINDS = ("train.nan_skip", "health.anomaly",
                 "numerics.scale_collapse", "parity.divergence",
                 "pallas.divergence", "autopilot.action",
                 "autopilot.revert")


def enabled() -> bool:
    """True when the postmortem plane is armed (``FLAGS_incident``)."""
    return bool(flag("incident"))


def subscribed_kinds() -> frozenset:
    """Flight kinds that trigger capture (``FLAGS_incident_kinds``,
    comma-separated; empty = :data:`DEFAULT_KINDS`)."""
    raw = str(flag("incident_kinds") or "").strip()
    if not raw:
        return frozenset(DEFAULT_KINDS)
    return frozenset(k.strip() for k in raw.split(",") if k.strip())


def incident_dir() -> str:
    """Bundle root (``FLAGS_incident_dir``; empty = ``incidents`` under
    the current directory)."""
    return str(flag("incident_dir") or "") or os.path.join(
        os.getcwd(), "incidents")


# ---------------------------------------------------------------------------
# state helpers (shared with tools/replay.py)
# ---------------------------------------------------------------------------

def train_surface(step):
    """The innermost object with the TrainStep surface (``model`` /
    ``optimizer`` / ``_opt_states``): a ResilientTrainStep notes itself,
    but state capture, restore and hashing happen on the wrapped step."""
    cur = step
    for _ in range(4):
        if getattr(cur, "model", None) is not None:
            return cur
        nxt = getattr(cur, "step", None)
        if nxt is None:
            return cur
        cur = nxt
    return cur


@contextlib.contextmanager
def whole_params(step):
    """The parameters of ``step``'s TrainStep surface whole for the
    duration: a ``ShardedTrainStep`` at ZeRO stage 3 keeps them as chunks
    between calls (each ``p.data`` empty), so they are all-gathered back
    into the module here and chunked again after (a collective: every
    rank enters it, as every rank calls the step).  A no-op for any other
    step."""
    surf = train_surface(step)
    if not getattr(surf, "_pshards", None):
        yield surf
        return
    surf._gather_chunks()
    try:
        yield surf
    finally:
        surf._release_params()


def host_copy(obj, reuse=None):
    """A host copy of a tensor (or of a dict of them), into ``reuse``'s
    buffer of the same shape and dtype where there is one; a card's
    tensor goes to pinned memory without waiting (the caller
    synchronises)."""
    if isinstance(obj, dict):
        reuse = reuse if isinstance(reuse, dict) else {}
        return {k: host_copy(v, reuse.get(k)) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        buf = reuse if isinstance(reuse, torch.Tensor) and \
            reuse.shape == t.shape and reuse.dtype == t.dtype else \
            torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        return buf.copy_(t, non_blocking=t.is_cuda)
    return obj


def _host_prestate(step, reuse: Optional[dict] = None) -> Optional[dict]:
    """Host copy of a TrainStep-surface object's training state in the
    shape of ``checkpoint._capture_train_state`` (optimizer state in
    sorted order), so the inline bundle state restores through
    ``checkpoint.load_train_state``.  ``reuse``: an evicted ring entry's
    copy whose buffers take this one.  Stage 3's chunks are gathered
    first (:func:`whole_params`; the caller holds them whole)."""
    step = train_surface(step)
    model = getattr(step, "model", None)
    opt = getattr(step, "optimizer", None)
    if model is None or opt is None:
        return None
    reuse = reuse or {}
    states = getattr(step, "_opt_states", None) or {}
    pre = {
        "params": host_copy(dict(model.named_parameters()),
                           reuse.get("params")),
        "buffers": host_copy({n: b for n, b in model.named_buffers()
                             if b is not None}, reuse.get("buffers")),
        "opt_states": host_copy({n: {k: states[n][k]
                                    for k in sorted(states[n])}
                                for n in sorted(states)},
                               reuse.get("opt_states")),
        "global_step": np.int64(getattr(opt, "_global_step", 0)),
    }
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return pre


def state_tree_of_prestate(pre_state: dict) -> Dict[str, Any]:
    """Flat name -> array view of a :func:`_host_prestate` dict by the
    parity plane's names (parameters by name, ``opt['<p>']['<slot>']``
    for optimizer leaves): both halves of a bisection name the same
    leaf."""
    from paddle_tpu_torch.parallel.parity import _opt_leaves
    tree = dict(pre_state.get("params") or {})
    states = pre_state.get("opt_states")
    if states:
        tree.update(_opt_leaves(states))
    return tree


def hash_state_tree(tree: Dict[str, Any]) -> Dict[str, int]:
    """Per-leaf hash of a flat name -> array tree: numpy arrays by
    :func:`parallel.parity.leaf_hash_host`, tensors by
    ``leaf_hash_device`` where they lie (bitwise the host hash), read back
    once a device."""
    from paddle_tpu_torch.parallel.parity import (leaf_hash_device,
                                                  leaf_hash_host)
    out, by_dev = {}, {}
    for n in sorted(tree):
        t = tree[n]
        if isinstance(t, torch.Tensor):
            by_dev.setdefault(t.device, []).append(
                (n, leaf_hash_device(t)))
        else:
            out[n] = leaf_hash_host(t)
    for pairs in by_dev.values():
        vals = torch.stack([h for _, h in pairs]).tolist()
        out.update((n, int(v)) for (n, _), v in zip(pairs, vals))
    return {n: out[n] for n in sorted(out)}


def hash_step_state(step) -> Dict[str, int]:
    """Per-leaf host hash of a live step's parameter and optimizer
    leaves."""
    from paddle_tpu_torch.parallel.parity import _state_tree
    return hash_state_tree(_state_tree(train_surface(step)))


def _prestate_nbytes(pre_state) -> int:
    if isinstance(pre_state, dict):
        return sum(_prestate_nbytes(v) for v in pre_state.values())
    if isinstance(pre_state, torch.Tensor):
        return pre_state.numel() * pre_state.element_size()
    return int(getattr(pre_state, "nbytes", 0))


def _host_array(x) -> np.ndarray:
    """A step input as the numpy array the ring keeps."""
    if isinstance(x, torch.Tensor):
        from paddle_tpu_torch.parallel.parity import _host_numpy
        return np.array(_host_numpy(x))
    return np.array(x)


def _step_device(step) -> torch.device:
    model = getattr(train_surface(step), "model", None)
    for p in (model.parameters() if model is not None else ()):
        return p.device
    return torch.device("cpu")


# explicit generators whose state the ring records beside the defaults
_tracked: List[torch.Generator] = []


def track_generator(gen) -> None:
    """Record ``gen``'s state in every ring entry (a ``torch.Generator``
    or the port's ``Generator``), so a replay of a model that draws its
    dropout from it redraws the same bits."""
    g = getattr(gen, "_gen", gen)
    if all(g is not t for t in _tracked):
        _tracked.append(g)


def _rng_states(device: torch.device) -> List[np.ndarray]:
    """[the device's default generator state, the CPU's (when the device
    is a card), each tracked generator's], as uint8 arrays."""
    out = []
    if device.type == "cuda":
        out.append(torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()].get_state())
    out.append(torch.default_generator.get_state())
    out.extend(g.get_state() for g in _tracked)
    return [s.numpy().copy() for s in out]


def restore_rng(states: List[np.ndarray], device) -> None:
    """Put back the random state a ring entry recorded
    (:func:`_rng_states` order) on ``device``."""
    device = torch.device(device)
    gens = []
    if device.type == "cuda":
        gens.append(torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()])
    gens.append(torch.default_generator)
    gens.extend(_tracked)
    for g, s in zip(gens, states):
        g.set_state(torch.from_numpy(np.asarray(s, np.uint8).copy()))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class IncidentRecorder:
    """Ring of recent step context and the capture listener.

    One process-wide instance (:data:`recorder`); the ring is built at
    the first armed note from ``FLAGS_incident_ring``.  Mutation happens
    under one lock; capture runs under a thread-local reentrancy guard
    (capture fires flight events of its own)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: Optional[collections.deque] = None
        self._installed = False
        self._tls = threading.local()
        self._program: Optional[dict] = None
        self.notices: collections.deque = collections.deque(maxlen=64)
        self.last_bundle: Optional[str] = None
        self.captured_total = 0

    # -- ring ----------------------------------------------------------------
    def _buf(self) -> collections.deque:
        if self._ring is None:
            self._ring = collections.deque(
                maxlen=max(1, int(flag("incident_ring"))))
        return self._ring

    def note(self, step, inputs) -> None:
        """Record one step's replay context (the armed path; callers gate
        on :func:`enabled`)."""
        from paddle_tpu_torch.framework.observability import flight
        ins = [("tensor" if isinstance(x, torch.Tensor) else "array",
                _host_array(x)) for x in inputs]
        surf = train_surface(step)
        with self._lock:
            ring = self._buf()
            old = ring[0] if len(ring) == ring.maxlen else None
        from paddle_tpu_torch.parallel.parity import _state_tree
        entry = {
            "step": int(getattr(getattr(surf, "optimizer", None),
                                "_global_step", 0)),
            "inputs": ins,
            "rng": _rng_states(_step_device(step)),
            "chaos": chaos.arm_state(),
            "flight_seq": flight.last_seq(),
        }
        # the trajectory hash of the pre-step state, taken on the live
        # tensors (bitwise the host copy's), and the host copy, both of
        # the whole parameters
        with whole_params(surf):
            entry["pre_hashes"] = hash_state_tree(_state_tree(surf))
            entry["pre_state"] = _host_prestate(
                step, old["pre_state"] if old is not None else None)
        entry["step_obj"] = step
        with self._lock:
            self._buf().append(entry)

    # -- program descriptor --------------------------------------------------
    def set_program(self, builder: str, **kwargs) -> None:
        """How a replay rebuilds this process's step: ``builder`` is a
        ``"module:function"`` returning the step object when called with
        ``**kwargs`` (JSON-able).  Stamped into every bundle."""
        self._program = {"builder": str(builder), "kwargs": dict(kwargs)}

    # -- listener ------------------------------------------------------------
    def install(self) -> None:
        """Subscribe the capture listener to the flight recorder
        (idempotent)."""
        from paddle_tpu_torch.framework.observability import flight
        with self._lock:
            if self._installed:
                return
            self._installed = True
        flight.add_listener(self._on_event)

    def uninstall(self) -> None:
        from paddle_tpu_torch.framework.observability import flight
        with self._lock:
            if not self._installed:
                return
            self._installed = False
        flight.remove_listener(self._on_event)

    def _on_event(self, ev: dict) -> None:
        """The flight listener: a subscribed kind writes a bundle and
        stamps the live event with its incident id.  Never raises."""
        if getattr(self._tls, "in_capture", False):
            return
        try:
            if not enabled() or ev.get("kind") not in subscribed_kinds():
                return
        except Exception:          # noqa: BLE001 - flags gone in teardown
            return
        self._tls.in_capture = True
        try:
            chaos.fault_point("incident.capture",
                              meta={"kind": ev.get("kind")})
            bundle = self._capture(ev)
            if bundle is not None:
                ev["attrs"]["incident"] = bundle["incident_id"]
        except Exception:          # noqa: BLE001 - the recorder never
            # crashes the run it records
            monitor.stat_add("incident_capture_errors_total")
        finally:
            self._tls.in_capture = False

    # -- capture -------------------------------------------------------------
    def _claim_bundle_dir(self, root: str):
        """A monotonic incident id from a directory scan, claimed by an
        exclusive mkdir (two racing captures get distinct ids)."""
        os.makedirs(root, exist_ok=True)
        nxt = 1
        for name in os.listdir(root):
            if name.startswith(BUNDLE_PREFIX):
                try:
                    nxt = max(nxt, int(name[len(BUNDLE_PREFIX):]) + 1)
                except ValueError:
                    continue
        for iid in range(nxt, nxt + 1000):
            path = os.path.join(root, f"{BUNDLE_PREFIX}{iid:06d}")
            try:
                os.makedirs(path)
                return iid, path
            except FileExistsError:
                continue
        raise RuntimeError(f"cannot claim an incident dir under {root}")

    @staticmethod
    def _save_array(path: str, fname: str, arr) -> dict:
        from paddle_tpu_torch.distributed import checkpoint
        crc, nbytes = checkpoint._atomic_save(
            path, fname, checkpoint._npy_parts(arr))
        return {"file": fname, "crc32": crc, "bytes": nbytes}

    def _capture(self, ev: dict) -> Optional[dict]:
        from paddle_tpu_torch.distributed import checkpoint
        from paddle_tpu_torch.framework.observability import flight
        with self._lock:
            entries = list(self._buf())
        iid, path = self._claim_bundle_dir(incident_dir())

        # 1) the state: inline at most the cap, else a reference to the
        # newest verified generation
        cap_bytes = float(flag("incident_state_cap_mb")) * 1e6
        pre = entries[0]["pre_state"] if entries else None
        if pre is not None and 0 < _prestate_nbytes(pre) <= cap_bytes:
            sdir = os.path.join(path, STATE_DIRNAME)
            checkpoint.save_sharded(pre, sdir, step=int(pre["global_step"]))
            checkpoint.write_commit(sdir,
                                    generation=int(pre["global_step"]))
            state_rec: Dict[str, Any] = {"inline": True,
                                         "dir": STATE_DIRNAME}
        else:
            state_rec = {"inline": False,
                         "ref": self._generation_ref(entries)}

        # 2) the input ring: one crc-stamped .npy an array, tmp + rename
        ring_meta: List[dict] = []
        for i, e in enumerate(entries):
            files = []
            for j, (kind, arr) in enumerate(e["inputs"]):
                rec = self._save_array(path, f"ring_e{i}_in{j}.npy", arr)
                rec["kind"] = kind
                files.append(rec)
            rng = e["rng"]
            meta = {"step": e["step"], "inputs": files,
                    "rng": self._save_array(path, f"ring_e{i}_rng.npy",
                                            rng[0]),
                    "chaos": e["chaos"], "flight_seq": e["flight_seq"]}
            if len(rng) > 1:
                meta["rng_more"] = [
                    self._save_array(path, f"ring_e{i}_rng{k}.npy", s)
                    for k, s in enumerate(rng[1:], 1)]
            ring_meta.append(meta)

        # 3) trajectory hashes for --bisect: entry i's post-state is
        # entry i + 1's pre-state; the last entry's post-state is the
        # live state now (capture runs inside flight.record, before any
        # restore)
        trajectory: List[dict] = []
        for e in entries:
            pre = e.get("pre_hashes")
            if pre is None and e["pre_state"] is not None:
                pre = hash_state_tree(state_tree_of_prestate(e["pre_state"]))
            trajectory.append({"step": e["step"], "pre_hashes": pre})
        post_hashes = None
        # (stage 3's chunks would need a collective here, inside a
        # listener that one rank may run alone: no post-state hash then)
        if entries and entries[-1].get("step_obj") is not None and \
                not getattr(train_surface(entries[-1]["step_obj"]),
                            "_pshards", None):
            try:
                post_hashes = hash_step_state(entries[-1]["step_obj"])
            except Exception:      # noqa: BLE001 - the hash is best-effort
                post_hashes = None

        # 4) the manifest (crc-stamped into COMMIT), COMMIT strictly last
        since = entries[0]["flight_seq"] if entries else 0
        manifest: Dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "incident_id": iid,
            "ts": time.time(),
            "worker": {"pid": os.getpid(),
                       "host": _hostname(),
                       "worker": os.environ.get("PADDLE_TRAINER_ID")},
            "event": {"kind": ev.get("kind"),
                      "severity": ev.get("severity"),
                      "seq": ev.get("seq"),
                      "attrs": _jsonable(ev.get("attrs", {}))},
            "flags_overrides": _flags_overrides(),
            "chaos": entries[0]["chaos"] if entries else chaos.arm_state(),
            "chaos_at_capture": chaos.arm_state(),
            "monitor": _monitor_snapshot(),
            "flight_tail": _jsonable(flight.since(since)),
            "program": self._program,
            "state": state_rec,
            "ring": ring_meta,
            "trajectory": trajectory,
            "post_hashes": post_hashes,
        }
        blame = _blame_window()
        if blame is not None:
            manifest["blame"] = blame
        from paddle_tpu_torch.distributed.fleet.utils.fs import LocalFS
        payload = json.dumps(manifest, default=str)
        LocalFS().atomic_write(os.path.join(path, MANIFEST_NAME), payload)
        LocalFS().atomic_write(
            os.path.join(path, COMMIT_NAME),
            json.dumps({"incident_id": iid, "time": time.time(),
                        "manifest_crc32":
                            zlib.crc32(payload.encode()) & 0xFFFFFFFF}))

        monitor.stat_add("incident_captured_total")
        self.captured_total += 1
        self.last_bundle = path
        self.notices.append({
            "id": iid, "kind": ev.get("kind"),
            "step": entries[-1]["step"] if entries else None,
            "bundle": path,
            "worker": manifest["worker"]["worker"]
            or manifest["worker"]["host"]})
        flight.record("incident.captured", severity="info",
                      incident=iid, trigger=ev.get("kind"), bundle=path)
        self._ledger_record(manifest, path)
        return manifest

    def _generation_ref(self, entries) -> Optional[dict]:
        """{root, generation} of the durable manager the ringed step was
        given (``attach_durable``): the newest verified generation saved
        at exactly the ring's first step, the one state a replay can run
        the whole ring from.  None without a manager or such a
        generation (the reference takes the newest verified one, whose
        step may lie before or after the ring: a replay from it skips or
        repeats steps)."""
        cur = entries[-1].get("step_obj") if entries else None
        mgr = None
        for _ in range(3):
            if cur is None:
                break
            mgr = getattr(cur, "_durable", None)
            if mgr is not None:
                break
            cur = getattr(cur, "step", None)
        if mgr is None:
            return None
        from paddle_tpu_torch.distributed import checkpoint
        from paddle_tpu_torch.distributed.durable import generation_dirs
        start = entries[0]["step"]
        try:
            for g, d in reversed(generation_dirs(mgr.root)):
                if checkpoint.is_committed(d) and \
                        checkpoint.checkpoint_meta(d).get("step") == start \
                        and not checkpoint.verify_checkpoint(d, deep=False):
                    return {"root": os.path.abspath(mgr.root),
                            "generation": int(g)}
        except Exception:          # noqa: BLE001
            return None
        return None

    def _ledger_record(self, manifest: dict, path: str) -> None:
        """A ``kind=incident`` run-ledger record (the ledger's append
        never raises)."""
        from paddle_tpu_torch.framework import runlog
        lpath = runlog.default_ledger_path()
        if not lpath:
            return
        attrs = manifest["event"].get("attrs") or {}
        info = {"id": manifest["incident_id"],
                "kind": manifest["event"].get("kind"),
                "step": manifest["ring"][-1]["step"]
                if manifest["ring"] else None,
                "first_bad_leaf": attrs.get("first_bad_leaf"),
                "bundle": os.path.abspath(path),
                "worker": manifest["worker"].get("worker")
                or manifest["worker"].get("host")}
        rec = runlog.capture(kind="incident",
                             label=manifest["event"].get("kind"),
                             include_snapshot=False,
                             extra={"incident": info})
        runlog.RunLedger(lpath).append(rec)

    def reset(self) -> None:
        """Clear the ring and the notices (tests); the listener stays."""
        with self._lock:
            self._ring = None
            self.notices.clear()
            self.last_bundle = None


def _hostname() -> str:
    import socket
    try:
        return socket.gethostname()
    except Exception:              # noqa: BLE001
        return "unknown"


def _flags_overrides() -> dict:
    from paddle_tpu_torch.framework import flags as _flags
    try:
        return _jsonable(_flags.overrides())
    except Exception:              # noqa: BLE001
        return {}


def _monitor_snapshot() -> Optional[dict]:
    try:
        return _jsonable(monitor.snapshot())
    except Exception:              # noqa: BLE001
        return None


def _blame_window() -> Optional[dict]:
    """The blame split when a tracer is live (``FLAGS_trace_dir``), best
    effort: a torn trace must not fail a capture."""
    try:
        tdir = str(flag("trace_dir") or "")
        if not tdir:
            return None
        from paddle_tpu_torch.framework import blame as _blame
        res = _blame.compute_blame(_blame.load_trace_dir(tdir))
        if not res.get("n_steps"):
            return None
        return {"n_steps": res["n_steps"], "totals_ms": res["totals_ms"],
                "per_step_ms": res["per_step_ms"],
                "top_category": res["top_category"]}
    except Exception:              # noqa: BLE001
        return None


def _jsonable(obj):
    """Round-trip through JSON with default=str, so an exotic attribute
    cannot tear the manifest write."""
    return json.loads(json.dumps(obj, default=str))


# ---------------------------------------------------------------------------
# module-level facade
# ---------------------------------------------------------------------------

#: the process-wide recorder
recorder = IncidentRecorder()


def maybe_note(step, inputs) -> None:
    """The hook the step classes call at the head of each step: one flag
    lookup disarmed; armed, ring-record this step's replay context and
    subscribe the capture listener (once)."""
    if not enabled():
        return
    recorder.install()
    try:
        recorder.note(step, inputs)
    except Exception:              # noqa: BLE001 - the ring never crashes
        # the watched step
        monitor.stat_add("incident_capture_errors_total")


def install() -> None:
    """Subscribe the capture listener before a first armed step (for
    processes whose subscribed kinds can fire first)."""
    recorder.install()


def uninstall() -> None:
    recorder.uninstall()


def set_program(builder: str, **kwargs) -> None:
    """See :meth:`IncidentRecorder.set_program`."""
    recorder.set_program(builder, **kwargs)


def reset() -> None:
    """Clear the ring, the notices and the tracked generators (tests)."""
    recorder.reset()
    del _tracked[:]


def drain_notices() -> List[dict]:
    """The incident notices ({id, kind, step, bundle, worker}) since
    process start, bounded: what the collector client ships in its push
    (cumulative: a dropped push must not lose one; the server dedups by
    id)."""
    return list(recorder.notices)


# ---------------------------------------------------------------------------
# bundle readers (shared with tools/replay.py and the tests)
# ---------------------------------------------------------------------------

def _check_file(path: str, rec: dict) -> Optional[dict]:
    fp = os.path.join(path, rec["file"])
    try:
        with open(fp, "rb") as f:
            data = f.read()
    except OSError:
        return {"file": rec["file"], "reason": "missing"}
    if len(data) != rec.get("bytes"):
        return {"file": rec["file"], "reason": "truncated"}
    if (zlib.crc32(data) & 0xFFFFFFFF) != rec.get("crc32"):
        return {"file": rec["file"], "reason": "crc_mismatch"}
    return None


def verify_bundle(path: str) -> List[dict]:
    """Check one bundle directory; ``[]`` = intact.  A missing or torn
    COMMIT, a manifest whose crc disagrees with the COMMIT stamp, a
    missing or corrupt ring file, or a torn inline state each give a
    ``{file, reason}`` problem; replay refuses a bundle with any."""
    problems: List[dict] = []
    try:
        with open(os.path.join(path, COMMIT_NAME)) as f:
            commit = json.load(f)
    except (OSError, ValueError):
        return [{"file": COMMIT_NAME, "reason": "missing"}]
    try:
        with open(os.path.join(path, MANIFEST_NAME), "rb") as f:
            raw = f.read()
    except OSError:
        return [{"file": MANIFEST_NAME, "reason": "missing"}]
    want = commit.get("manifest_crc32")
    if want is not None and (zlib.crc32(raw) & 0xFFFFFFFF) != want:
        return [{"file": MANIFEST_NAME, "reason": "crc_mismatch"}]
    try:
        manifest = json.loads(raw.decode("utf-8"))
    except ValueError:
        return [{"file": MANIFEST_NAME, "reason": "bad_manifest"}]
    for e in manifest.get("ring", []):
        for rec in (list(e.get("inputs", [])) + [e.get("rng")]
                    + list(e.get("rng_more", []))):
            if rec:
                bad = _check_file(path, rec)
                if bad is not None:
                    problems.append(bad)
    state = manifest.get("state") or {}
    if state.get("inline"):
        from paddle_tpu_torch.distributed import checkpoint
        sdir = os.path.join(path, state.get("dir") or STATE_DIRNAME)
        if not checkpoint.is_committed(sdir):
            problems.append({"file": state.get("dir") or STATE_DIRNAME,
                             "reason": "state_uncommitted"})
        else:
            problems.extend(checkpoint.verify_checkpoint(sdir, deep=True))
    return problems


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        return json.load(f)


def load_ring_entry(path: str, entry: dict) -> dict:
    """One manifest ring entry read back: inputs (kind, array), the
    random states (:func:`restore_rng` order) and the chaos schedule."""
    inputs = [(rec.get("kind", "array"),
               np.load(os.path.join(path, rec["file"])))
              for rec in entry.get("inputs", [])]
    rng = None
    if entry.get("rng"):
        rng = [np.load(os.path.join(path, r["file"]))
               for r in [entry["rng"]] + list(entry.get("rng_more", []))]
    return {"step": entry.get("step"), "inputs": inputs, "rng": rng,
            "chaos": entry.get("chaos")}
