"""Instrumented lock plane (port of paddle_tpu/framework/locks.py): named
Lock / RLock wrappers and a runtime lock-order watchdog.

* :func:`lock` / :func:`rlock` are named drop-ins for
  ``threading.Lock()`` / ``threading.RLock()``.  Disarmed (the default)
  an acquisition costs one flag read on top of the primitive.  The
  parameter server's host tables (``distributed/ps``) and the tracer's
  and flight recorder's own locks are created through them.

* :class:`LockWatchdog`, armed by ``FLAGS_lock_watchdog``, records each
  thread's acquisition order, keeps the global held-before graph (edge
  A -> B: B was acquired while A was held) and on a cycle records a
  ``locks.cycle`` flight event naming it, once per distinct cycle.  A
  release that held the lock longer than ``FLAGS_lock_hold_warn_ms``
  records ``locks.long_hold``.  Metrics: ``lock_waits_total``,
  ``lock_hold_ms``, ``lock_cycles_total``, ``lock_long_holds_total``,
  ``lock_watchdog_errors_total``.

**The watchdog never raises.**  Every observation runs behind the
``locks.observe`` chaos point and a swallow-and-count guard, and a
per-thread latch keeps it from observing itself.

Lock names are one process-wide namespace: every lock made as
``locks.lock("ps.host_table")`` is one node of the graph, since lock
order is a property of the code path, not of the instance.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.flags import flag

__all__ = ["TrackedLock", "LockWatchdog", "lock", "rlock", "watchdog",
           "held_locks"]

monitor.describe("lock_waits_total",
                 "tracked-lock acquisitions that found the lock held "
                 "(contended) while the watchdog was armed")
monitor.describe("lock_hold_ms",
                 "tracked-lock hold time (ms) histogram, watchdog armed")
monitor.describe("lock_cycles_total",
                 "distinct lock-order cycles the runtime watchdog has "
                 "named (locks.cycle flight events)")
monitor.describe("lock_long_holds_total",
                 "tracked-lock releases past FLAGS_lock_hold_warn_ms")
monitor.describe("lock_watchdog_errors_total",
                 "watchdog observations swallowed (locks.observe chaos "
                 "trips and real bookkeeping failures) — the watched "
                 "lock proceeds untouched")


class LockWatchdog:
    """Process-wide held-before graph + per-thread acquisition stacks.

    All mutating entry points (:meth:`note_acquire`,
    :meth:`note_release`, :meth:`note_wait`) swallow every exception —
    see the module docstring.  Read surfaces (:meth:`graph`,
    :meth:`cycles`, :meth:`held`) are for tests/tools."""

    def __init__(self):
        # graph + cycle bookkeeping guarded by a PLAIN lock (the
        # watchdog must not watch itself)
        self._glock = threading.Lock()
        self._graph: Dict[str, Dict[str, Tuple[str, int]]] = {}
        self._cycles: List[List[str]] = []
        self._reported: Set[frozenset] = set()
        self._local = threading.local()
        self._seen: Set[str] = set()
        self.errors = 0

    # -- per-thread state ---------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _observing(self) -> bool:
        return getattr(self._local, "busy", False)

    # -- observation points (never raise) -----------------------------------
    def note_wait(self, name: str):
        try:
            if self._observing():
                return
            self._local.busy = True
            try:
                monitor.stat_add("lock_waits_total")
            finally:
                self._local.busy = False
        except Exception:                  # noqa: BLE001 — never raises
            self.errors += 1
            try:
                monitor.stat_add("lock_watchdog_errors_total")
            except Exception:              # noqa: BLE001
                pass

    def note_acquire(self, name: str):
        try:
            if self._observing():
                return
            self._local.busy = True
            try:
                from paddle_tpu_torch.framework import chaos
                chaos.fault_point("locks.observe", meta={"lock": name})
                stack = self._stack()
                held = [n for n, _, _ in stack]
                stack.append((name, time.perf_counter(),
                              name in held))
                self._seen.add(name)
                for h in held:
                    if h != name:
                        self._add_edge(h, name)
            finally:
                self._local.busy = False
        except Exception:                  # noqa: BLE001 — never raises
            self.errors += 1
            monitor.stat_add("lock_watchdog_errors_total")

    def note_release(self, name: str, emit: bool = True):
        try:
            # cheap bail BEFORE the latch: release calls this
            # unconditionally (so a flag flip mid-hold cannot leak a
            # stack entry into a bogus future edge), and a disarmed
            # process must pay only this getattr
            st = getattr(self._local, "stack", None)
            if not st:
                return
            if self._observing():
                return
            self._local.busy = True
            try:
                stack = st
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][0] == name:
                        _, t0, reentrant = stack.pop(i)
                        if reentrant or not emit:
                            return         # inner RLock hold: outer owns
                        held_ms = (time.perf_counter() - t0) * 1e3
                        monitor.observe("lock_hold_ms", held_ms)
                        warn_ms = float(flag("lock_hold_warn_ms"))
                        if warn_ms > 0 and held_ms > warn_ms:
                            monitor.stat_add("lock_long_holds_total")
                            from paddle_tpu_torch.framework.observability \
                                import flight
                            flight.record(
                                "locks.long_hold", severity="warn",
                                lock=name, held_ms=round(held_ms, 3),
                                warn_ms=warn_ms,
                                thread=threading.current_thread().name)
                        return
            finally:
                self._local.busy = False
        except Exception:                  # noqa: BLE001 — never raises
            self.errors += 1
            monitor.stat_add("lock_watchdog_errors_total")

    # -- held-before graph --------------------------------------------------
    def _add_edge(self, a: str, b: str):
        """Record "b acquired while a held"; on a NEW edge, check for a
        cycle through it and fire locks.cycle once per distinct cycle."""
        import traceback
        with self._glock:
            edges = self._graph.setdefault(a, {})
            if b in edges:
                return
            site = traceback.extract_stack(limit=8)
            caller = next(
                ((f.filename, f.lineno) for f in reversed(site)
                 if "framework/locks" not in f.filename.replace(
                     "\\", "/")), ("?", 0))
            edges[b] = (str(caller[0]), int(caller[1]))
            path = self._find_path(b, a)
            if path is None:
                return
            cycle = path + [b]             # a ... -> a closing through b
            key = frozenset(cycle)
            if key in self._reported:
                return
            self._reported.add(key)
            self._cycles.append(cycle)
        monitor.stat_add("lock_cycles_total")
        from paddle_tpu_torch.framework.observability import flight
        flight.record("locks.cycle", severity="error", cycle=cycle,
                      edge=[a, b], site=f"{caller[0]}:{caller[1]}",
                      thread=threading.current_thread().name)

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src -> dst over the held-before edges (graph lock
        held by the caller)."""
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._graph.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- read surfaces ------------------------------------------------------
    def graph(self) -> Dict[str, List[str]]:
        """Held-before adjacency (name -> sorted successor names)."""
        with self._glock:
            return {a: sorted(bs) for a, bs in self._graph.items()}

    def cycles(self) -> List[List[str]]:
        with self._glock:
            return [list(c) for c in self._cycles]

    def held(self) -> List[str]:
        """Locks the CALLING thread currently holds, acquisition order."""
        return [n for n, _, _ in self._stack()]

    def seen(self) -> List[str]:
        """Every lock name observed since arming/reset, sorted — leaf
        locks included (the held-before graph only shows NESTED
        acquisitions; this answers "did the run exercise lock X at
        all", the adoption-coverage question)."""
        with self._glock:
            return sorted(self._seen)

    def reset(self):
        with self._glock:
            self._graph.clear()
            self._cycles.clear()
            self._reported.clear()
            self._seen.clear()
        self.errors = 0


#: process-wide watchdog every TrackedLock reports to
watchdog = LockWatchdog()


def held_locks() -> List[str]:
    """Tracked locks the calling thread holds (debug/test surface)."""
    return watchdog.held()


def _armed() -> bool:
    return bool(flag("lock_watchdog"))


class TrackedLock:
    """A named ``threading.Lock``/``RLock`` that reports to the
    watchdog when ``FLAGS_lock_watchdog`` is set.  Disarmed, acquire
    and release add one flag lookup each to the primitive's cost.
    Supports the full lock protocol (``with``, ``acquire(blocking,
    timeout)``, ``release``, ``locked``)."""

    __slots__ = ("name", "reentrant", "_lock")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = str(name)
        self.reentrant = bool(reentrant)
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _armed():
            return self._lock.acquire(blocking, timeout)
        got = self._lock.acquire(False)
        if not got:
            watchdog.note_wait(self.name)
            if not blocking:
                return False
            got = self._lock.acquire(True, timeout)
            if not got:
                return False
        watchdog.note_acquire(self.name)
        return True

    def release(self):
        # unconditional: a watchdog disarmed between acquire and
        # release must still reconcile the per-thread stack, or the
        # stale entry fabricates held-before edges (and spurious
        # locks.cycle events) once re-armed.  Metrics/events only emit
        # while armed; the disarmed no-stack path is one getattr.
        watchdog.note_release(self.name, emit=_armed())
        self._lock.release()

    def locked(self) -> bool:
        if self.reentrant:
            # RLock has no locked(); probe without blocking.  True when
            # ANOTHER thread holds it (an owning thread re-acquires).
            got = self._lock.acquire(False)
            if got:
                self._lock.release()
                return False
            return True
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self):
        kind = "rlock" if self.reentrant else "lock"
        return f"TrackedLock({self.name!r}, {kind})"

    # pickling (DataLoader spawn workers carry datasets by value): the
    # primitive is recreated unlocked in the child, same as a plain
    # threading lock field would have to be
    def __getstate__(self):
        return {"name": self.name, "reentrant": self.reentrant}

    def __setstate__(self, d):
        object.__setattr__(self, "name", d["name"])
        object.__setattr__(self, "reentrant", d["reentrant"])
        object.__setattr__(
            self, "_lock",
            threading.RLock() if d["reentrant"] else threading.Lock())


def lock(name: str) -> TrackedLock:
    """A named non-reentrant tracked lock (``threading.Lock`` drop-in)."""
    return TrackedLock(name, reentrant=False)


def rlock(name: str) -> TrackedLock:
    """A named reentrant tracked lock (``threading.RLock`` drop-in)."""
    return TrackedLock(name, reentrant=True)
