"""Elastic training: membership epochs, hang watchdog, shrink-to-survive
(port of paddle_tpu/distributed/elastic.py, host Python as there; on the
card it runs at world size 1, one card holding one NCCL rank).

Reference roles: the fleet elastic layer —
  * python/paddle/distributed/fleet/launch_utils.py watch_local_trainers
    (:522) grown into a *membership* supervisor: a crashed OR hung child
    becomes a leave, not a job kill;
  * python/paddle/distributed/fleet/base/role_maker.py's PADDLE_* env
    rendezvous, made re-readable mid-job (PaddleCloudRoleMaker.refresh);
  * the etcd store of paddle's elastic manager, reduced to what a
    single-host/NFS deployment needs: a file- or dict-backed lease table.

Protocol.  Every worker holds a **lease** in a :class:`RendezvousStore`
and renews it each step; any join, leave, or lease expiry bumps the
store's **membership epoch**.  Workers watch the epoch: on a bump the
survivors run :func:`reform` — refresh the role maker from the live
member list, restore params from the latest committed two-slot
checkpoint
(:class:`~paddle_tpu_torch.framework.auto_checkpoint.TrainEpochRange`
protocol), fence the parameter servers so a stale pre-epoch worker's
pushes are rejected (PsServer epoch check), and resume at the new world
size.  Shrink-to-survive: the job keeps training with the workers it
still has.  Grow-on-join: a replacement's ``register`` bumps the epoch
the same way and the next re-form deals it back in.

Liveness has two independent watchdogs:

* **lease expiry** — a worker that stops renewing (crash, network
  partition, injected ``elastic.lease`` fault) is expired by any peer's
  ``sweep()`` after ``ttl`` seconds;
* **progress deadline** — :class:`ElasticAgent` kills a child whose
  progress beat is older than ``hang_deadline`` (the straggler/hung case
  a crash monitor never sees; injectable via ``elastic.worker_hang``),
  then treats it as a leave and restarts a replacement under the same
  backoff/budget rules as a crash.

Everything is deterministically testable on CPU: :class:`DictStore`
takes an injectable clock, :class:`ElasticAgent.poll_once` is a pure
supervision pass returning its events, and tests/test_torch_elastic.py
drives a 4→3 shrink to loss parity with an uninterrupted 3-worker run,
in process and over gloo processes.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.framework import chaos, locks
from paddle_tpu_torch.framework.observability import flight

__all__ = ["LeaseExpired", "Evicted", "RendezvousStore", "DictStore",
           "FileStore", "ElasticWorkerContext", "WorkerHandle",
           "ProcHandle", "LocalHandle", "ElasticAgent", "reform",
           "reshard_tables", "dp_shard"]


class LeaseExpired(RuntimeError):
    """Raised by ``renew`` when the worker's lease is gone from the live
    set — the peers have already counted it out; re-``register`` (a join,
    epoch bump) is the only way back in."""


class Evicted(RuntimeError):
    """Raised by role refresh when this worker is no longer a member."""


# ---------------------------------------------------------------------------
# rendezvous store: leases + membership epochs
# ---------------------------------------------------------------------------

class RendezvousStore:
    """Lease table with membership epochs (shared logic; backends supply
    locked state load/store).

    State: ``{"epoch": int, "workers": {id: {"expires", "endpoint",
    "progress", "step", "joined_epoch"}}}``.  Every membership change —
    register, leave, sweep-expiry — bumps ``epoch`` exactly once per
    mutating call; renew and progress beats never do.
    """

    def __init__(self, ttl: float = 10.0,
                 clock: Optional[Callable[[], float]] = None):
        self.ttl = float(ttl)
        self.clock = clock or time.time

    # backends implement: _locked() ctx manager yielding a mutable state
    # dict whose mutations are persisted on exit
    def _locked(self):
        raise NotImplementedError

    @staticmethod
    def _blank():
        return {"epoch": 0, "workers": {}}

    # -- membership mutations (each bumps the epoch) ------------------------
    def register(self, worker: str, endpoint: Optional[str] = None) -> int:
        """Join (or re-join) the membership; returns the (possibly
        bumped) epoch.  A re-register without an explicit ``endpoint``
        keeps the one on record (the agent restarting a child knows its
        name, not its port), so a restart can never downgrade a real
        endpoint to None.  Registering a worker that already holds a
        LIVE lease is idempotent — it refreshes the lease but does NOT
        bump the epoch, so the launcher-registers-then-the-worker-joins
        double registration costs one membership change, not two
        (each bump makes every survivor run a full re-form)."""
        now = self.clock()
        with self._locked() as st:
            prev = st["workers"].get(worker)
            if endpoint is None and prev is not None:
                endpoint = prev.get("endpoint")
            if prev is not None and prev["expires"] >= now:
                prev["expires"] = now + self.ttl
                prev["endpoint"] = endpoint
                return st["epoch"]
            st["epoch"] += 1
            st["workers"][worker] = {
                "expires": now + self.ttl,
                "endpoint": endpoint,
                "progress": now,
                "step": -1,
                "joined_epoch": st["epoch"],
            }
            return st["epoch"]

    def leave(self, worker: str) -> int:
        """Deliberate leave; idempotent (a second leave does not bump)."""
        with self._locked() as st:
            if worker in st["workers"]:
                del st["workers"][worker]
                st["epoch"] += 1
            return st["epoch"]

    def sweep(self) -> List[str]:
        """Expire stale leases; any peer may call this (leaderless).
        Returns the expired worker ids; a non-empty sweep bumps the epoch
        once."""
        now = self.clock()
        with self._locked() as st:
            expired = [w for w, rec in st["workers"].items()
                       if rec["expires"] < now]
            for w in expired:
                del st["workers"][w]
            if expired:
                st["epoch"] += 1
            return expired

    # -- lease renewal / progress (never bump) ------------------------------
    def renew(self, worker: str) -> float:
        """Extend the lease; returns the new deadline.  The
        ``elastic.lease`` chaos point fires before the store write, so an
        injected fault is exactly a lost renewal: the lease runs out and
        a peer's sweep expires it."""
        # a failed renew IS the fault being modeled: the lease expires and the
        # sweep/epoch path recovers
        chaos.fault_point("elastic.lease", meta={"worker": worker})
        now = self.clock()
        with self._locked() as st:
            rec = st["workers"].get(worker)
            if rec is None:
                raise LeaseExpired(
                    f"worker {worker!r} holds no lease (expired and swept, "
                    "or never registered) — re-register to rejoin")
            rec["expires"] = now + self.ttl
            return rec["expires"]

    def beat(self, worker: str, step: Optional[int] = None):
        """Progress heartbeat for the hang watchdog; no epoch effect."""
        now = self.clock()
        with self._locked() as st:
            rec = st["workers"].get(worker)
            if rec is None:
                return
            rec["progress"] = now
            if step is not None:
                rec["step"] = int(step)

    # -- reads --------------------------------------------------------------
    def epoch(self) -> int:
        with self._locked() as st:
            return st["epoch"]

    def members(self) -> List[str]:
        with self._locked() as st:
            return sorted(st["workers"])

    def membership(self) -> Tuple[int, List[str], List[Optional[str]]]:
        """One atomic read: (epoch, sorted member ids, their endpoints)."""
        with self._locked() as st:
            ids = sorted(st["workers"])
            return (st["epoch"], ids,
                    [st["workers"][w]["endpoint"] for w in ids])

    def progress_age(self, worker: str) -> Optional[float]:
        """Seconds since the worker's last progress beat (None if gone)."""
        now = self.clock()
        with self._locked() as st:
            rec = st["workers"].get(worker)
            return None if rec is None else now - rec["progress"]

    def progress(self, worker: str) -> Optional[Tuple[float, int]]:
        """(seconds since last beat, last step) — step is -1 until the
        worker's first ``beat``, which is how the watchdog tells an
        elastic-aware trainer that stopped beating (hung) from a plain
        script that never beats (exempt from the hang deadline)."""
        now = self.clock()
        with self._locked() as st:
            rec = st["workers"].get(worker)
            if rec is None:
                return None
            return now - rec["progress"], rec["step"]


class DictStore(RendezvousStore):
    """In-process backend (threads share one dict) — the deterministic
    test harness and the single-supervisor deployment."""

    def __init__(self, ttl: float = 10.0, clock=None):
        super().__init__(ttl, clock)
        self._state = self._blank()
        self._lock = locks.rlock("elastic.store")

    def _locked(self):
        import contextlib

        @contextlib.contextmanager
        def cm():
            with self._lock:
                yield self._state
        return cm()


class FileStore(RendezvousStore):
    """File backend: one JSON state file guarded by an ``fcntl`` lock
    file, so independently-launched worker *processes* on one host (or an
    NFS mount) share leases.  Writes commit via tmp+rename (crash-safe,
    same discipline as LocalFS.atomic_write)."""

    def __init__(self, path: str, ttl: float = 10.0, clock=None):
        super().__init__(ttl, clock)
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self._lockpath = path + ".lock"

    def _locked(self):
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def cm():
            with open(self._lockpath, "a+") as lf:
                fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
                try:
                    try:
                        with open(self.path) as f:
                            raw = f.read()
                        st = json.loads(raw)
                    except (OSError, ValueError):
                        raw, st = None, self._blank()
                    yield st
                    out = json.dumps(st)
                    if out == raw:
                        return          # read-only pass (epoch polls every
                    tmp = f"{self.path}.tmp.{os.getpid()}"  # step): no write
                    with open(tmp, "w") as f:
                        f.write(out)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, self.path)
                    # durability: the rename lives in the directory
                    # inode — without this a power cut can resurrect a
                    # stale membership file (fs.fsync_dir rationale)
                    from paddle_tpu_torch.distributed.fleet.utils.fs import \
                        fsync_dir
                    fsync_dir(os.path.dirname(self.path))
                finally:
                    fcntl.flock(lf.fileno(), fcntl.LOCK_UN)
        return cm()


# ---------------------------------------------------------------------------
# worker side: lease + progress + epoch watch in one handle
# ---------------------------------------------------------------------------

class ElasticWorkerContext:
    """What one worker holds: its lease, its progress beats, and the
    epoch it last formed at.  ``step_done`` is the one call a train loop
    makes per step; ``membership_changed`` is what it polls before the
    next step.

    Store-write pacing: every beat/renew is a locked read-modify-write —
    on a :class:`FileStore` a full json+fsync+rename — so a
    millisecond-step train loop should not write every step.
    ``renew_interval`` (default ``ttl/2``; 0 = every call) and
    ``beat_interval`` (default 0 — set to about ``hang_deadline/4`` when
    the steps are much faster than the watchdog's resolution) bound the
    write rate while keeping both watchdogs fed."""

    def __init__(self, store: RendezvousStore, worker_id: str,
                 endpoint: Optional[str] = None,
                 renew_interval: Optional[float] = None,
                 beat_interval: float = 0.0,
                 epoch_poll_interval: float = 0.0):
        self.store = store
        self.worker_id = worker_id
        self.endpoint = endpoint
        self.renew_interval = store.ttl / 2.0 if renew_interval is None \
            else float(renew_interval)
        self.beat_interval = float(beat_interval)
        # epoch polls are locked full-file reads on a FileStore; pace
        # them like the writes when steps are fast (detection latency =
        # the interval, same order as the watchdogs' own resolution)
        self.epoch_poll_interval = float(epoch_poll_interval)
        self._last_renew = -1e18
        self._last_beat = -1e18
        self._last_epoch_poll = -1e18
        self._seen_epoch = -1
        self.epoch = -1
        self.lost_lease = False

    def join(self) -> int:
        self.epoch = self.store.register(self.worker_id, self.endpoint)
        # registering freshened the lease and progress record
        self._last_renew = self._last_beat = self.store.clock()
        self.lost_lease = False
        flight.record("elastic.join", worker=self.worker_id,
                      epoch=self.epoch)
        return self.epoch

    def step_done(self, step: int):
        """Per-step liveness: straggler injection point, progress beat,
        lease renewal.  A failed renewal (injected ``elastic.lease``
        fault, swept lease, store I/O error) flips ``lost_lease`` — the
        worker must stop pushing and either exit or re-``join``."""
        # the agent's hang_deadline watchdog owns recovery: a stalled beat gets
        # the worker killed and replaced
        chaos.fault_point("elastic.worker_hang",
                          meta={"worker": self.worker_id, "step": step})
        now = self.store.clock()
        try:
            if now - self._last_beat >= self.beat_interval:
                self.store.beat(self.worker_id, step)
                self._last_beat = now
            if now - self._last_renew >= self.renew_interval:
                self.store.renew(self.worker_id)
                self._last_renew = now
        except (LeaseExpired, chaos.InjectedFault, OSError) as e:
            self.lost_lease = True
            flight.record("elastic.lease_lost", severity="warn",
                          worker=self.worker_id, step=step, exc=repr(e))
            raise

    def membership_changed(self) -> bool:
        now = self.store.clock()
        if now - self._last_epoch_poll >= self.epoch_poll_interval:
            self._seen_epoch = self.store.epoch()
            self._last_epoch_poll = now
        return self._seen_epoch != self.epoch

    def resync(self, epoch: Optional[int] = None) -> int:
        """Adopt the epoch the re-form ran under.  Pass the epoch
        :func:`reform` returned — re-reading the store here would swallow
        a bump that landed between the re-form's atomic membership read
        and this call, leaving the worker training at a stale rank/world
        with ``membership_changed()`` false."""
        self.epoch = self.store.epoch() if epoch is None else int(epoch)
        self._seen_epoch = self.epoch
        return self.epoch

    def leave(self):
        self.store.leave(self.worker_id)


# ---------------------------------------------------------------------------
# agent side: crash + hang supervision over generic worker handles
# ---------------------------------------------------------------------------

class WorkerHandle:
    """Supervision protocol the agent drives.  ``ProcHandle`` wraps a
    launch ``_Child`` subprocess; ``LocalHandle`` runs a callable on a
    thread (cooperative kill) for in-process tests."""

    name: str

    def alive(self) -> bool:
        raise NotImplementedError

    def exit_code(self) -> Optional[int]:
        raise NotImplementedError

    def kill(self, grace: float = 0.0):
        raise NotImplementedError

    def restart(self):
        raise NotImplementedError


class ProcHandle(WorkerHandle):
    """Wraps :class:`paddle_tpu_torch.distributed.launch._Child` (or anything
    with ``proc``/``restart``/``terminate``)."""

    def __init__(self, child):
        self.child = child
        self.name = child.name

    def alive(self) -> bool:
        return self.child.proc.poll() is None

    def exit_code(self) -> Optional[int]:
        return self.child.proc.poll()

    def kill(self, grace: float = 0.0):
        # default (grace=0): hard kill, no SIGTERM — the agent kills only
        # children it has already judged hung or fenced, and a
        # supervision pass that blocks in a graceful-shutdown wait would
        # stall the lease renewals every healthy peer depends on.
        # grace>0 is the PREEMPTION contract (ElasticAgent term_grace):
        # SIGTERM first, so the child's crash-handler chain gets the
        # window to run its deadline-bounded emergency checkpoint save
        # (observability.on_sigterm), then SIGKILL whatever remains.
        proc = self.child.proc
        if proc.poll() is None:
            if grace > 0:
                proc.terminate()
                try:
                    proc.wait(timeout=grace)
                except Exception:        # noqa: BLE001 — still alive
                    pass
            if proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout=5)     # reap; instant after SIGKILL
            except Exception:            # noqa: BLE001
                pass
        lf = self.child.log_file
        if lf and not lf.closed:
            lf.close()

    def restart(self):
        self.child.restart()


class LocalHandle(WorkerHandle):
    """Thread-backed worker for deterministic in-process tests.  The
    target is called as ``target(stop_event)`` and must poll the event;
    ``kill`` is cooperative: it sets the event and the handle immediately
    counts as not-alive for supervision purposes — matching a SIGKILL'd
    child whose OS teardown outlives the poll that killed it."""

    def __init__(self, name: str,
                 target: Callable[[threading.Event], None]):
        self.name = name
        self.target = target
        self.stop = threading.Event()
        self.killed = False
        self._rc: Optional[int] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        # fresh stop event per incarnation: a killed predecessor still
        # draining a sleep keeps its OWN (set) event and exits, without
        # being able to stop — or report into — the replacement
        self.stop = threading.Event()
        self.killed = False
        self._rc = None

        stop = self.stop

        def run():
            me = threading.current_thread()
            try:
                self.target(stop)
                rc = 0
            except BaseException:       # noqa: BLE001 — worker crash
                rc = 1
            if self._thread is me:      # stale incarnations stay silent
                # single-store handoff: run() stores once, exit_code() reads
                # after is_alive() goes False — the GIL makes the reference
                # store atomic; owner: elastic
                self._rc = rc
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def alive(self) -> bool:
        if self.killed:
            return False
        return self._thread is not None and self._thread.is_alive()

    def exit_code(self) -> Optional[int]:
        if self.killed:
            return -9
        if self._thread is None or self._thread.is_alive():
            return None
        return self._rc

    def kill(self, grace: float = 0.0):
        # the stop event IS the graceful path; grace adds nothing here
        self.killed = True
        self.stop.set()

    def restart(self):
        self.start()


class ElasticAgent:
    """Job-level supervisor: crash *and* hang detection over a set of
    worker handles, with the store as the membership ledger.

    One ``poll_once`` pass (deterministic, returns its events):

    1. sweep expired leases — each expiry fences the worker (its handle,
       if still running, is killed) and already bumped the epoch;
    2. a crashed child (non-zero exit) becomes a ``leave`` and, while its
       retry budget lasts, a delayed restart — exponential backoff
       ``restart_backoff * 2^restarts`` capped at ``backoff_cap``, budget
       reset after ``healthy_interval`` seconds of continuous life;
    3. a child whose progress beat is older than ``hang_deadline`` is
       killed (hung/straggling — it will never exit on its own) and then
       follows the same leave+restart path;
    4. a restarted child re-``register``s itself: grow-on-join.

    The job is *done* (``poll_once`` returns ``("done", rc)`` in the
    events) when every handle has exited 0, and *failed* when a handle is
    out of budget — unless ``min_world`` survivors remain, in which case
    the job shrinks instead of dying (shrink-to-survive).
    """

    def __init__(self, store: RendezvousStore,
                 handles: Sequence[WorkerHandle],
                 hang_deadline: float = 30.0,
                 elastic_retries: int = 2,
                 restart_backoff: float = 0.5,
                 backoff_cap: float = 10.0,
                 healthy_interval: float = 30.0,
                 min_world: int = 1,
                 clock: Optional[Callable[[], float]] = None,
                 log: Callable[[str], None] = None,
                 member_names: Optional[Sequence[str]] = None,
                 endpoints: Optional[Dict[str, str]] = None,
                 first_beat_deadline: Optional[float] = None,
                 straggler_ttl: float = 60.0,
                 term_grace: float = 0.0):
        self.store = store
        self.handles = list(handles)
        # member -> host:port, re-attached when the agent re-registers a
        # restarted child (its leave deleted the record, and the agent —
        # unlike the worker itself — knows the endpoint it launched with)
        self.endpoints = dict(endpoints or {})
        # which handles participate in the MEMBERSHIP (data-parallel
        # world).  A PS launch supervises server children too, but only
        # trainers may appear in the member list a refreshed role maker
        # ranks against — a server in it would silently skew dp sharding.
        self.member_names = set(member_names) if member_names is not None \
            else {h.name for h in self.handles}
        self.hang_deadline = float(hang_deadline)
        self.elastic_retries = int(elastic_retries)
        self.restart_backoff = float(restart_backoff)
        self.backoff_cap = float(backoff_cap)
        self.healthy_interval = float(healthy_interval)
        self.min_world = int(min_world)
        # seconds of SIGTERM grace granted before any kill (0 = the
        # classic hard kill).  The preemption contract: grace >= the
        # workers' FLAGS_ckpt_emergency_deadline lets every kill path —
        # fence, hang, straggler shrink, shutdown — land one final
        # emergency checkpoint generation before SIGKILL
        self.term_grace = float(term_grace)
        # a worker that registered but NEVER beat is exempt from the
        # hang deadline (plain scripts don't beat at all); with
        # elastic-aware trainers, set first_beat_deadline to also catch
        # a worker hung in init before its first step — the one hang
        # the never-beaten exemption would otherwise hide forever
        self.first_beat_deadline = first_beat_deadline
        self.clock = clock or time.monotonic
        self.log = log or (lambda m: None)
        self.events: List[tuple] = []
        #: latest cluster-reported straggler scores (collector hook —
        #: see note_stragglers); empty until a collector reports.  Raw
        #: last-report values — read through straggler_view(), which
        #: drops expired/evicted workers (collector worker_ttl idiom)
        self.straggler_scores: Dict[str, float] = {}
        self._straggling: set = set()
        # staleness bookkeeping: last report time per scored worker and
        # first continuously-flagged time per straggler — a dead
        # worker's frozen score must never drive the shrink policy
        self.straggler_ttl = float(straggler_ttl)
        self._straggler_ts: Dict[str, float] = {}
        self._straggler_since: Dict[str, float] = {}
        self._straggler_lock = locks.lock("elastic.stragglers")
        self._restarts: Dict[str, int] = {}
        self._alive_since: Dict[str, float] = {}
        self._restart_at: Dict[str, float] = {}
        self._last_renew: Dict[str, float] = {}
        self._gone: set = set()
        self._failed_names: set = set()
        self._exited_clean: set = set()

    # -- one deterministic supervision pass ---------------------------------
    def poll_once(self) -> List[tuple]:
        now = self.clock()
        events: List[tuple] = []

        # the agent is the local liveness authority: it renews the lease
        # of every child it can SEE alive (a plain training script never
        # talks to the store), so lease expiry is reserved for workers
        # whose supervisor is gone (multi-host peers, the SIGKILL case).
        # Renewals are paced at ttl/2 — renewing every poll would turn a
        # FileStore into fsync churn under one flock — which still leaves
        # half a ttl of supervisor-stall slack before expiry.
        for h in self.handles:
            if h.name in self.member_names and h.name not in self._gone \
                    and h.name not in self._restart_at and h.alive() and \
                    now - self._last_renew.get(h.name, -1e18) >= \
                    self.store.ttl / 2.0:
                try:
                    self.store.renew(h.name)
                    self._last_renew[h.name] = now
                except (LeaseExpired, chaos.InjectedFault, OSError):
                    pass                     # the sweep path owns this

        for w in self.store.sweep():
            events.append(("lease_expired", w))
            h = self._by_name(w)
            if h is not None and h.alive():
                h.kill(self.term_grace)      # fence: the lease is gone
                events.append(("fenced", w))

        for h in self.handles:
            if h.name in self._gone:
                continue
            if h.name in self._restart_at:
                if now >= self._restart_at[h.name]:
                    del self._restart_at[h.name]
                    h.restart()
                    self._alive_since[h.name] = now
                    if h.name in self.member_names:
                        self.store.register(
                            h.name, endpoint=self.endpoints.get(h.name))
                    events.append(("restarted", h.name))
                continue
            rc = h.exit_code()
            if rc is None:                   # alive: budget reset + hang?
                if (now - self._alive_since.setdefault(h.name, now)
                        >= self.healthy_interval):
                    self._restarts[h.name] = 0
                if h.name not in self.member_names:
                    continue                 # non-member (PS server): no
                                             # lease, no hang watchdog
                prog = self.store.progress(h.name)
                if prog is not None:
                    # beaten workers: age vs hang_deadline.  Never-beaten
                    # (step -1, progress = register time): exempt unless
                    # first_beat_deadline is armed (init-hang detection
                    # for elastic-aware trainers)
                    deadline = self.hang_deadline if prog[1] >= 0 \
                        else self.first_beat_deadline
                    if deadline is not None and prog[0] > deadline:
                        h.kill(self.term_grace)
                        self.store.leave(h.name)
                        events.append(("hang_killed", h.name, prog[0]))
                        self._schedule_or_shrink(h, now, events)
                continue
            if rc == 0:
                # clean exit is a deliberate LEAVE, not a failure: drop
                # the lease now so the survivors re-form immediately
                # instead of ttl seconds later via a spurious expiry
                if h.name in self.member_names and \
                        h.name not in self._exited_clean:
                    self._exited_clean.add(h.name)
                    self.store.leave(h.name)
                    events.append(("left", h.name))
                continue
            self.store.leave(h.name)
            events.append(("crashed", h.name, rc))
            self._schedule_or_shrink(h, now, events)

        if not self._failed_names and \
                all(h.exit_code() == 0 for h in self.handles
                    if h.name not in self._gone):
            events.append(("done", 0))
        self.events.extend(events)
        for ev in events:
            self.log(f"elastic-agent: {ev}")
            flight.record("elastic." + ev[0],
                          severity=self._EVENT_SEVERITY.get(ev[0], "info"),
                          detail=list(ev[1:]), epoch=self.store.epoch())
        return events

    _EVENT_SEVERITY = {
        "crashed": "error", "failed": "error", "hang_killed": "error",
        "lease_expired": "warn", "fenced": "warn", "shrunk": "warn",
        "restart_scheduled": "warn", "straggler_killed": "warn",
    }

    def _schedule_or_shrink(self, h: WorkerHandle, now: float,
                            events: List[tuple]):
        used = self._restarts.get(h.name, 0)
        if used < self.elastic_retries:
            self._restarts[h.name] = used + 1
            delay = min(self.restart_backoff * (2 ** used),
                        self.backoff_cap)
            self._restart_at[h.name] = now + delay
            events.append(("restart_scheduled", h.name, delay))
            return
        if h.name not in self.member_names:
            # a PS server out of budget cannot be "shrunk" away — its
            # table shard has no substitute; that is a job failure
            self._gone.add(h.name)
            self._failed_names.add(h.name)
            events.append(("failed", h.name))
            return
        survivors = sum(1 for o in self.handles
                        if o is not h and o.name in self.member_names and
                        o.name not in self._gone and
                        (o.alive() or o.name in self._restart_at))
        if survivors >= self.min_world:
            self._gone.add(h.name)           # shrink-to-survive
            events.append(("shrunk", h.name))
        else:
            # terminal: tombstone so repeated poll_once passes don't
            # re-emit crashed/failed for the same corpse; _failed_names
            # (not _gone alone) keeps the job from ever reporting done
            self._gone.add(h.name)
            self._failed_names.add(h.name)
            events.append(("failed", h.name))

    def _by_name(self, name: str) -> Optional[WorkerHandle]:
        for h in self.handles:
            if h.name == name:
                return h
        return None

    def note_stragglers(self, scores: Dict[str, float],
                        flagged: Optional[Sequence[str]] = None,
                        threshold: Optional[float] = None):
        """Adopt the cluster collector's straggler view — the agent
        that today only sees HANGS (a worker whose progress beat went
        silent) also learns about workers that are merely *slow*
        (beating fine, dragging the cluster).  ``scores`` maps worker →
        step-time skew vs its peers; ``flagged`` is the collector's
        named-straggler list (recomputed from ``threshold``, default
        ``FLAGS_collector_straggler_ratio``, when absent).  Newly
        flagged / recovered workers record ``elastic.straggler`` flight
        events.

        This call only RECORDS: the agent's actual shrink/replace
        policy is :meth:`enforce_straggler_policy`, which acts on a
        worker only after it has been flagged *continuously* for a
        deadline — one slow interval never costs a worker its slot.
        Scores are stamped with the agent's clock; reads
        (:meth:`straggler_view`, :meth:`stragglers`,
        :meth:`straggler_overdue`) drop scores older than
        ``straggler_ttl`` or belonging to an evicted worker at READ
        time (the collector's ``worker_ttl`` re-check idiom), so a
        dead worker's frozen score can never drive a shrink.
        Thread-safe: the collector's handler threads call this while
        ``run()`` polls."""
        from paddle_tpu_torch.framework.flags import flag as _flag
        if flagged is None:
            thr = float(_flag("collector_straggler_ratio")) \
                if threshold is None else float(threshold)
            flagged = [w for w, s in scores.items() if s >= thr]
        now = self.clock()
        with self._straggler_lock:
            self.straggler_scores = dict(scores)
            self._straggler_ts = {w: now for w in scores}
            newly = set(flagged) - self._straggling
            recovered = self._straggling - set(flagged)
            self._straggling = set(flagged)
            # continuously-flagged since: kept across reports while the
            # worker stays flagged, reset the moment it recovers
            for w in newly:
                self._straggler_since[w] = now
            for w in recovered:
                self._straggler_since.pop(w, None)
        for w in sorted(newly):
            self.log(f"elastic-agent: straggler {w} "
                     f"(score {scores.get(w, 0.0):.2f})")
            flight.record("elastic.straggler", severity="warn",
                          worker=w, score=round(scores.get(w, 0.0), 3))
        for w in sorted(recovered):
            flight.record("elastic.straggler", severity="info",
                          worker=w, score=round(scores.get(w, 0.0), 3),
                          recovered=True)

    def _straggler_fresh_locked(self, name: str, now: float) -> bool:
        # read-time staleness re-check (collector worker_ttl idiom):
        # a score is live only if recently reported AND its worker is
        # still a member the agent could act on
        ts = self._straggler_ts.get(name)
        if ts is None or now - ts > self.straggler_ttl:
            return False
        if name in self._gone:
            return False
        # membership applies only when the agent manages workers: an
        # observer-mode agent (no handles) can't validate names, and
        # enforce_straggler_policy re-checks _by_name before acting
        return not self.handles or self._by_name(name) is not None

    def straggler_view(self) -> Dict[str, float]:
        """Live straggler scores: the raw collector report minus
        expired (older than ``straggler_ttl``) and evicted workers,
        re-evaluated at read time."""
        now = self.clock()
        with self._straggler_lock:
            return {w: s for w, s in self.straggler_scores.items()
                    if self._straggler_fresh_locked(w, now)}

    def stragglers(self) -> List[str]:
        """Currently flagged stragglers (collector-reported), minus
        expired/evicted workers (read-time re-check)."""
        now = self.clock()
        with self._straggler_lock:
            return sorted(w for w in self._straggling
                          if self._straggler_fresh_locked(w, now))

    def straggler_overdue(self, deadline_s: float) -> List[str]:
        """Stragglers flagged *continuously* for at least
        ``deadline_s`` seconds (and still fresh/members) — the set
        :meth:`enforce_straggler_policy` would act on right now."""
        now = self.clock()
        with self._straggler_lock:
            return sorted(
                w for w in self._straggling
                if self._straggler_fresh_locked(w, now) and
                now - self._straggler_since.get(w, now) >= deadline_s)

    def enforce_straggler_policy(self, deadline_s: float) -> List[tuple]:
        """Deadline-guarded shrink/replace for persistent stragglers.

        A worker the collector has flagged continuously for
        ``deadline_s`` seconds is treated like a hang: killed, its
        lease dropped, then routed through the normal
        restart-budget-then-shrink path (``_schedule_or_shrink``) — a
        replace while budget lasts, a shrink-to-survive after.  The
        staleness re-check means an already-dead or evicted worker is
        never acted on.  Returns the events it appended (also recorded
        as ``elastic.*`` flight events, same as ``poll_once``)."""
        now = self.clock()
        events: List[tuple] = []
        for name in self.straggler_overdue(deadline_s):
            h = self._by_name(name)
            if h is None or name in self._gone or name in self._restart_at:
                continue
            score = self.straggler_scores.get(name, 0.0)
            h.kill(self.term_grace)      # planned preemption: grant grace
            try:
                self.store.leave(name)
            except (LeaseExpired, chaos.InjectedFault, OSError):
                pass                         # lease sweep owns cleanup
            events.append(("straggler_killed", name, round(score, 3)))
            self._schedule_or_shrink(h, now, events)
            with self._straggler_lock:
                self._straggling.discard(name)
                self._straggler_since.pop(name, None)
        self.events.extend(events)
        for ev in events:
            self.log(f"elastic-agent: {ev}")
            flight.record("elastic." + ev[0],
                          severity=self._EVENT_SEVERITY.get(ev[0], "info"),
                          detail=list(ev[1:]), epoch=self.store.epoch())
        return events

    def arm_hang_deadline(self, histogram: str = "train_step_ms",
                          multiplier: float = 50.0, floor: float = 5.0,
                          cap: Optional[float] = None) -> float:
        """Arm the progress watchdog from the MEASURED step-time
        distribution (framework.health discipline) instead of a
        hardcoded budget: ``hang_deadline = clamp(multiplier *
        p99(histogram) seconds, floor, cap)``.  A job whose steps take
        50 ms gets a tight few-second deadline; one whose steps take
        30 s is not falsely killed by a budget sized for the former.
        Call after enough steps have landed in the histogram (e.g.
        post-warmup, or after a re-form); raises RuntimeError on an
        empty histogram — silently keeping the old deadline would look
        exactly like a successful arming."""
        from paddle_tpu_torch.framework import monitor
        h = monitor.get_histogram(histogram)
        if not h.count:
            raise RuntimeError(
                f"arm_hang_deadline: histogram {histogram!r} has no "
                "samples — run some steps before arming the measured "
                "deadline")
        p99_ms = h.percentile(0.99)
        deadline = max(float(floor), float(multiplier) * p99_ms / 1e3)
        if cap is not None:
            deadline = min(deadline, float(cap))
        self.hang_deadline = deadline
        flight.record("elastic.deadline_armed", histogram=histogram,
                      p99_ms=round(p99_ms, 3), samples=h.count,
                      hang_deadline=round(deadline, 3))
        return deadline

    def failed(self) -> bool:
        return bool(self._failed_names)

    def run(self, poll_interval: float = 0.2,
            timeout: Optional[float] = None) -> int:
        """Blocking supervision loop (the launch-integration form).
        Returns 0 when every non-shrunk child exited 0, 1 on failure."""
        deadline = None if timeout is None else self.clock() + timeout
        while True:
            events = self.poll_once()
            if any(ev[0] == "done" for ev in events):
                return 0
            if self.failed() or \
                    (deadline is not None and self.clock() > deadline):
                for h in self.handles:   # never orphan children: a dead
                    if h.alive():        # supervisor must not leave
                        h.kill(self.term_grace)  # trainers unsupervised
                return 1
            time.sleep(poll_interval)


# ---------------------------------------------------------------------------
# re-form: refresh roles, restore state, fence the PS epoch
# ---------------------------------------------------------------------------

def dp_shard(n: int, world: int, rank: int) -> slice:
    """Contiguous data-parallel shard of ``n`` items for ``rank`` of
    ``world`` (uneven remainders go to the low ranks, the layout the
    weighted gradient average in the elastic loop assumes)."""
    base, rem = divmod(n, world)
    start = rank * base + min(rank, rem)
    return slice(start, start + base + (1 if rank < rem else 0))


def reform(store: RendezvousStore, role_maker, worker_id: str,
           train_step=None, checkpoint_dir: Optional[str] = None,
           resilient=None, ps_client=None):
    """The shrink/grow re-form path every survivor runs on an epoch bump.

    1. if a :class:`~paddle_tpu_torch.framework.resilient.ResilientTrainStep`
       is given, surface ``membership_changed`` so a last-good snapshot
       exists *before* any layout mutation;
    2. ``role_maker.refresh(store=...)`` — rank/world from the live
       member list (raises :class:`Evicted` if we are not in it);
    3. restore params/opt state from the latest *committed* two-slot
       checkpoint (so every survivor resumes from the same step — the
       uncheckpointed tail is re-trained at the new world size);
    4. fence the PS tier: the client adopts the new epoch and installs it
       on every server, so a stale pre-epoch worker's pushes are rejected.

    Returns ``(epoch, rank, world, restored_step)`` — ``restored_step``
    is None when no committed checkpoint exists yet (resume from step 0).
    """
    # the refresh's atomic membership() read is the single epoch source:
    # fencing with a separately-read (possibly older) epoch would let a
    # worker evicted *between* the reads keep pushing under the old fence
    role_maker.refresh(store=store, worker_id=worker_id)
    epoch = role_maker._elastic_epoch
    if resilient is not None:
        # snapshot BEFORE any layout mutation (checkpoint restore below)
        resilient.membership_changed(epoch)
    restored_step = None
    if train_step is not None and checkpoint_dir is not None:
        from paddle_tpu_torch.framework.auto_checkpoint import \
            latest_checkpoint
        found = latest_checkpoint(checkpoint_dir)
        if found is not None:
            slot_dir, restored_step = found
            from paddle_tpu_torch.distributed.checkpoint import \
                load_train_state
            load_train_state(train_step, slot_dir)
            if resilient is not None:
                # re-snapshot the RESTORED state: the pre-reform snapshot
                # above is now stale, and the next NaN rollback must not
                # undo the checkpoint restore
                resilient.snapshot()
    if ps_client is not None:
        # fence + re-size the bye quorum to the re-formed world in one
        # op, so a shrunk job's servers still shut down on the last bye
        ps_client.set_epoch(epoch, fence_servers=True,
                            n_workers=role_maker.worker_num())
    flight.record("elastic.reform", worker=worker_id, epoch=epoch,
                  rank=role_maker.worker_index(),
                  world=role_maker.worker_num(),
                  restored_step=restored_step)
    return epoch, role_maker.worker_index(), role_maker.worker_num(), \
        restored_step


def reshard_tables(old_endpoints: Sequence[str],
                   new_endpoints: Sequence[str],
                   table_names: Sequence[str],
                   epoch: Optional[int] = None,
                   fallback: Optional[Dict[str, np.ndarray]] = None,
                   client_factory=None) -> Dict[str, int]:
    """Re-shard PS tables onto a new server set after membership change.

    Row ownership is ``id % n_servers`` (brpc key-mod routing), so any
    change in server count moves rows.  For each table: pull the full
    state from every *surviving* old server, keep each row from its old
    owner (rows whose old owner is gone come from ``fallback`` — e.g. the
    latest checkpointed table — or raise, because silently losing rows is
    the one thing a re-shard must never do), then ``load_state`` the
    re-assembled table into every new server and install ``epoch`` as its
    fence.  Returns ``{table: rows_recovered_from_fallback}``.

    ``fallback`` values are either a row array or a dict ``{"table":
    rows, "g2": per_row_accumulator}``.  For an adagrad table whose
    fallback carries no ``g2``, the recovered rows' accumulator is reset
    to 0 — fresh-row adagrad semantics (the accumulator self-seeds on
    the next push), chosen over inheriting a non-owner's stale copy.
    """
    from paddle_tpu_torch.distributed.ps.service import PsClient
    factory = client_factory or (lambda eps: PsClient(eps))
    old_n = len(old_endpoints)
    report: Dict[str, int] = {}

    old_client = factory(list(old_endpoints))
    new_client = factory(list(new_endpoints))
    if epoch is not None:
        # stamp the target epoch on every load_state so a server set
        # fenced by an earlier re-form accepts this (newer) re-shard
        new_client.epoch = int(epoch)
    try:
        # which old shards still answer?
        surviving: Dict[int, bool] = {}
        for s in range(old_n):
            try:
                old_client._rpc(s, {"op": "stat"}, retries=0)
                surviving[s] = True
            except (ConnectionError, OSError):
                surviving[s] = False
        for name in table_names:
            states: Dict[int, tuple] = {}
            for s in range(old_n):
                if not surviving[s]:
                    continue
                reply, bufs = old_client._rpc(
                    s, {"op": "state", "table": name})
                states[s] = (reply, bufs)
            rows = None
            merged = None
            merged_g2 = None
            optim = None
            has_g2 = False
            lost = 0
            for s, (reply, bufs) in states.items():
                table = bufs[0]
                if merged is None:
                    rows = table.shape[0]
                    merged = np.array(table)
                    optim = reply["optimizer"]
                    has_g2 = bool(reply.get("has_g2"))
                    if has_g2:
                        merged_g2 = np.array(bufs[1])
                owned = np.arange(rows) % old_n == s
                merged[owned] = table[owned]
                if has_g2:
                    merged_g2[owned] = bufs[1][owned]
            if merged is None:
                raise ConnectionError(
                    f"reshard: no surviving old server holds table "
                    f"{name!r}")
            dead_owned = np.zeros(rows, bool)
            for s in range(old_n):
                if not surviving[s]:
                    dead_owned |= np.arange(rows) % old_n == s
            if dead_owned.any():
                fb = (fallback or {}).get(name)
                if fb is None:
                    raise RuntimeError(
                        f"reshard: table {name!r} rows owned by dead "
                        f"servers ({int(dead_owned.sum())}) and no "
                        "fallback (checkpoint) given — refusing to lose "
                        "them silently")
                fb_g2 = None
                if isinstance(fb, dict):
                    fb_g2 = fb.get("g2")
                    fb = fb["table"]
                merged[dead_owned] = np.asarray(fb, np.float32)[dead_owned]
                if has_g2:
                    merged_g2[dead_owned] = (
                        np.asarray(fb_g2, np.float32)[dead_owned]
                        if fb_g2 is not None else 0.0)
                lost = int(dead_owned.sum())
            report[name] = lost
            for s in range(len(new_endpoints)):
                header = {"op": "load_state", "table": name,
                          "optimizer": optim, "has_g2": has_g2}
                bufs = [merged] + ([merged_g2] if has_g2 else [])
                new_client._rpc(s, header, bufs)
        if epoch is not None:
            new_client.set_epoch(epoch, fence_servers=True)
    finally:
        for c in (old_client, new_client):
            try:
                for conn in c._conns:
                    conn.close()
                c._pool.shutdown(wait=False)
            except Exception:            # noqa: BLE001
                pass
    return report
