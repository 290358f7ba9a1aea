"""Deterministic fault-injection ("chaos") registry (port of
paddle_tpu/framework/chaos.py): a seedable registry of named fault points
threaded through the code that must survive them.

The port's steps consult these points (grep for ``fault_point(``):

=====================  ====================================================
``zero.collective``     once per collective leg (reduce-scatter,
                        all-gather) at the head of
                        ``parallel/zero.py`` ``ShardedUpdateTrainStep``:
                        ``mode="error"`` is a dropped collective the step
                        re-issues (a bounded retry before any leg runs, so
                        the retried step is bit-identical)
``ps.pipeline``         each background prefetch of ``distributed/ps``
                        ``PSTrainStep``: ``mode="error"`` is a failed
                        prefetch, which the step replaces by a synchronous
                        pull after replaying its push
``health.detector``     head of every health observation
                        (``framework/health.py``): an injected error is
                        swallowed and counted
``locks.observe``       head of every armed lock-watchdog observation
                        (``framework/locks.py``): swallowed and counted
=====================  ====================================================

:data:`FAULT_POINTS` declares the reference's whole list, the points of
modules still to port included, so a spec written for the reference arms
here too.

Injection is schedule-driven and deterministic: ``nth`` (trip on the Nth
call), ``every`` (every Nth call), ``p`` (seeded probability), bounded by
``n_times``.  A trip applies the point's ``mode``: ``"error"`` raises
:class:`InjectedFault`, ``"latency"`` sleeps ``latency`` seconds,
``"nan"`` NaN-poisons the floating tensors of the payload (each on its own
device, in its own dtype) and returns them.  For the same spec and seed a
point fires on the same calls as the reference's.

Arming, in precedence order: the :func:`inject` context manager
(``with chaos.inject("zero.collective", mode="error", nth=1): ...``), or
``FLAGS_chaos_spec`` (a JSON object ``{"<point>": {"mode": ..., ...}}``)
and ``FLAGS_chaos_seed``, read once at first use.  Nothing armed, a fault
point is one dict lookup.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["InjectedFault", "FaultSpec", "fault_point", "inject", "arm",
           "disarm", "stats", "reset", "arm_from_flags", "FAULT_POINTS",
           "register_fault_point", "known_fault_points",
           "payload_fault_points", "arm_state", "restore_state"]

FAULT_POINTS = ("ps.rpc", "ps.pipeline", "data.pipeline", "fs.write",
                "ckpt.save", "ckpt.async", "ckpt.verify",
                "download.fetch", "train.step_grads",
                "elastic.lease", "elastic.worker_hang",
                "health.detector", "zero.collective",
                "numerics.observe", "runlog.observe", "collector.rpc",
                "locks.observe", "parity.observe", "autopilot.act",
                "pallas.verify", "incident.capture")
_known_points = set(FAULT_POINTS)
# points whose fault_point() call carries a payload (the only ones where
# mode="nan" can transform anything)
_payload_points = {"train.step_grads"}


def register_fault_point(name: str, carries_payload: bool = False):
    """Declare a custom fault point so arm()/FLAGS_chaos_spec accept it.
    In-tree points are pre-registered; arming an UNDECLARED name raises —
    a typo'd spec silently injecting nothing is exactly the
    false-green-chaos-run this registry exists to prevent.  Pass
    ``carries_payload=True`` when your fault_point() call site hands in
    arrays, to unlock ``mode="nan"`` for it."""
    _known_points.add(name)
    if carries_payload:
        _payload_points.add(name)
    return name


def known_fault_points() -> frozenset:
    """Every declared fault point name — in-tree plus anything added via
    :func:`register_fault_point`.  Consumer API for the static analyzer
    (framework.analysis rules PTA301/PTA302): the linter validates
    ``fault_point("...")`` call sites against this registry and flags
    sites with no retry/backoff guard, so a chaos-armed point can never
    be a name the registry would reject nor a call path that escalates
    an injected fault straight into a crash."""
    return frozenset(_known_points)


def payload_fault_points() -> frozenset:
    """Declared points whose call sites carry a payload (the only ones
    where ``mode="nan"`` transforms anything) — see known_fault_points."""
    return frozenset(_payload_points)


class InjectedFault(ConnectionError):
    """Raised by an armed ``mode="error"`` fault point.

    Subclasses ConnectionError so transport-layer retry paths (PS RPC)
    treat an injected drop exactly like a real one; elsewhere it
    propagates like the crash it simulates."""


class FaultSpec:
    """One armed fault point's schedule + mode."""

    def __init__(self, mode: str = "error", nth: Optional[int] = None,
                 every: Optional[int] = None, p: float = 0.0,
                 latency: float = 0.0, n_times: Optional[int] = None,
                 message: str = "", payload_index: Optional[int] = None):
        if mode not in ("error", "latency", "nan"):
            raise ValueError(f"unknown chaos mode {mode!r}")
        self.mode = mode
        self.nth = nth
        self.every = every
        self.p = float(p)
        self.latency = float(latency)
        self.n_times = n_times
        self.message = message
        # mode="nan" targeting: poison only the payload_index-th element
        # of a tuple/list payload (e.g. ONE input of a train step, so a
        # NaN reaches exactly the parameter leaves that input feeds —
        # the numerics plane's per-leaf provenance is provable only
        # with a fault this surgical); None poisons every float array
        self.payload_index = payload_index
        self.calls = 0
        self.trips = 0

    def should_trip(self, rng: np.random.Generator) -> bool:
        self.calls += 1
        if self.n_times is not None and self.trips >= self.n_times:
            return False
        hit = False
        if self.nth is not None and self.calls == self.nth:
            hit = True
        if self.every is not None and self.calls % self.every == 0:
            hit = True
        if self.p > 0.0 and rng.random() < self.p:
            hit = True
        if hit:
            self.trips += 1
        return hit


class ChaosRegistry:
    def __init__(self, seed: int = 0):
        self._specs: Dict[str, FaultSpec] = {}
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.armed = False               # fast-path gate for fault_point

    def arm(self, name: str, **spec) -> FaultSpec:
        if name not in _known_points:
            raise ValueError(
                f"unknown fault point {name!r} — in-tree points: "
                f"{sorted(_known_points)}; declare custom sites with "
                "register_fault_point() first")
        if spec.get("mode") == "nan" and name not in _payload_points:
            raise ValueError(
                f"fault point {name!r} carries no payload — mode='nan' "
                "would inject nothing (false-green chaos); payload "
                f"points: {sorted(_payload_points)}")
        fs = FaultSpec(**spec)
        with self._lock:
            self._specs[name] = fs
            self.armed = True
        return fs

    def disarm(self, name: Optional[str] = None):
        with self._lock:
            if name is None:
                self._specs.clear()
            else:
                self._specs.pop(name, None)
            self.armed = bool(self._specs)

    def reseed(self, seed: int):
        # under the registry lock: fire() reads the generator under it,
        # and a reseed racing a fire must swap the reference atomically
        # with the schedule state (PTA403)
        with self._lock:
            self._seed = int(seed)
            self._rng = np.random.default_rng(seed)

    def export_state(self) -> Dict[str, Any]:
        """JSON-able snapshot of the whole injection state: seed, the
        probability stream's mid-sequence generator state, and every
        armed spec WITH its call/trip counters — what an incident
        bundle records so a replay resumes the exact fault schedule a
        mid-run incident saw, not the schedule from call zero."""
        with self._lock:
            specs = {}
            for name, s in self._specs.items():
                specs[name] = {
                    "mode": s.mode, "nth": s.nth, "every": s.every,
                    "p": s.p, "latency": s.latency, "n_times": s.n_times,
                    "message": s.message,
                    "payload_index": s.payload_index,
                    "calls": s.calls, "trips": s.trips}
            return {"seed": self._seed, "armed": self.armed,
                    "rng_state": self._rng.bit_generator.state,
                    "specs": specs}

    def import_state(self, state: Dict[str, Any]):
        """Reinstall an :meth:`export_state` snapshot: specs are rebuilt
        with their call/trip counters reinstated, and the probability
        stream resumes from the recorded generator state (falling back
        to a fresh seed when the snapshot predates ``rng_state``)."""
        specs = {}
        for name, kw in dict(state.get("specs") or {}).items():
            kw = dict(kw)
            calls = int(kw.pop("calls", 0))
            trips = int(kw.pop("trips", 0))
            fs = FaultSpec(**kw)
            fs.calls, fs.trips = calls, trips
            specs[name] = fs
        with self._lock:
            self._seed = int(state.get("seed", 0))
            self._rng = np.random.default_rng(self._seed)
            rng_state = state.get("rng_state")
            if rng_state is not None:
                self._rng.bit_generator.state = rng_state
            self._specs = specs
            self.armed = bool(specs)

    def fire(self, name: str, payload: Any = None, meta: dict = None):
        spec = self._specs.get(name)
        if spec is None:
            return payload
        with self._lock:
            trip = spec.should_trip(self._rng)
        if not trip:
            return payload
        # every trip lands in the flight recorder: a post-mortem dump
        # shows the injected fault right before the recovery machinery's
        # own events (retry, mark_dead, rollback, re-form)
        from paddle_tpu_torch.framework.observability import flight
        flight.record("chaos.trip", severity="warn", point=name,
                      mode=spec.mode, call=spec.calls,
                      **({"meta": meta} if meta else {}))
        if spec.mode == "latency":
            time.sleep(spec.latency)
            return payload
        if spec.mode == "nan":
            return _poison(payload, index=spec.payload_index)
        raise InjectedFault(
            f"chaos[{name}] injected fault (call {spec.calls}"
            + (f", {meta}" if meta else "") + ")"
            + (f": {spec.message}" if spec.message else ""))

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {n: {"calls": s.calls, "trips": s.trips}
                    for n, s in self._specs.items()}


def _poison(payload, index=None):
    """NaN-poison every floating tensor or array in ``payload`` (its first
    element, enough for any finiteness sweep to trip); other leaves pass
    through untouched.  ``index`` (FaultSpec ``payload_index``) restricts
    the poison to one element of a tuple/list payload."""
    if payload is None:
        return None
    if isinstance(payload, (list, tuple)):
        if index is not None:
            out = list(payload)
            if not -len(out) <= index < len(out):
                raise IndexError(
                    f"chaos payload_index {index} out of range for a "
                    f"{len(out)}-element payload")
            out[index] = _poison(out[index])
            return type(payload)(out)
        return type(payload)(_poison(p) for p in payload)
    if isinstance(payload, torch.Tensor):
        return _poison_tensor(payload)
    return _poison_array(payload)


def _poison_tensor(t: torch.Tensor) -> torch.Tensor:
    """A copy of a floating tensor with a NaN first element, on the
    tensor's own device and in its own dtype (no host round trip)."""
    if not t.is_floating_point():
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    out.view(-1)[0] = float("nan")
    return out


def _poison_array(arr):
    try:
        a = np.asarray(arr)
    except Exception:                            # noqa: BLE001
        return arr
    if not np.issubdtype(a.dtype, np.floating):
        return arr
    a = a.copy()
    a.reshape(-1)[0] = np.nan
    return a


_registry = ChaosRegistry()
_env_armed = False
_explicit_seed = False


def arm_from_flags(force: bool = False):
    """Arm the registry from FLAGS_chaos_spec / FLAGS_chaos_seed (env or
    set_flags).  Called lazily on the first fault_point hit so a launcher
    can arm an entire child-process tree via the environment.  The env
    seed is applied only when no explicit reset(seed)/reseed happened
    first — lazy env arming must never clobber a seed the caller pinned
    (unless ``force=True`` re-reads the flags deliberately)."""
    global _env_armed
    if _env_armed and not force:
        return
    _env_armed = True
    from paddle_tpu_torch.framework.flags import flag
    if force or not _explicit_seed:
        _registry.reseed(int(flag("chaos_seed")))
    raw = flag("chaos_spec")
    if not raw:
        return
    spec = json.loads(raw) if isinstance(raw, str) else dict(raw)
    for name, kw in spec.items():
        _registry.arm(name, **kw)


def fault_point(name: str, payload: Any = None, meta: dict = None):
    """Consult the chaos registry at a named site.  Returns the payload
    (possibly NaN-poisoned), raises :class:`InjectedFault`, or sleeps,
    per the armed schedule; a no-op returning ``payload`` when nothing
    is armed for ``name``."""
    if not _env_armed:
        arm_from_flags()
    if not _registry.armed:
        return payload
    return _registry.fire(name, payload, meta)


def arm(name: str, **spec) -> FaultSpec:
    if not _env_armed:
        arm_from_flags()
    return _registry.arm(name, **spec)


def disarm(name: Optional[str] = None):
    _registry.disarm(name)


def reset(seed: int = 0):
    """Disarm everything and reseed — each chaos test starts here."""
    global _explicit_seed
    _explicit_seed = True
    _registry.disarm()
    _registry.reseed(seed)


def stats() -> Dict[str, Dict[str, int]]:
    return _registry.stats()


def arm_state() -> Dict[str, Any]:
    """JSON-able snapshot of the full chaos state — seed, mid-sequence
    rng stream, and every armed spec with its call/trip counters.
    Recorded into incident bundles so :func:`restore_state` resumes the
    exact fault schedule a mid-run incident saw (the seed alone would
    replay from call zero, a different schedule)."""
    if not _env_armed:
        arm_from_flags()
    return _registry.export_state()


def restore_state(state: Dict[str, Any]):
    """Reinstall an :func:`arm_state` snapshot (replay's arming path).

    Pins the seed as explicit (lazy env arming must not clobber a
    restored stream) and auto-registers spec names this process has not
    declared — they were valid where the snapshot was taken, and a
    replay refusing its own recorded schedule would be the
    false-green the registry exists to prevent."""
    global _env_armed, _explicit_seed
    _env_armed = True
    _explicit_seed = True
    for name in dict(state.get("specs") or {}):
        if name not in _known_points:
            register_fault_point(name, carries_payload=True)
    _registry.import_state(state)


@contextlib.contextmanager
def inject(name: str, **spec):
    """Scope one armed fault point::

        with chaos.inject("ps.rpc", mode="error", nth=2, n_times=1):
            client.pull(...)     # the 2nd RPC raises InjectedFault
    """
    fs = arm(name, **spec)
    try:
        yield fs
    finally:
        disarm(name)
