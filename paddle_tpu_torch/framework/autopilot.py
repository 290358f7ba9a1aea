"""Autopilot: a guarded runtime controller that turns telemetry into
recovery actions (port of paddle_tpu/framework/autopilot.py, host Python
as there; ``tests/test_torch_autopilot.py`` holds its decisions to the
reference's).

Every earlier plane ends at a signal — a flight event, a health
anomaly, a blame share, a straggler score — and a human is the only
actuator.  This module closes the loop: a :class:`Controller` ticks
once per train step, and every ``FLAGS_autopilot_interval_steps`` steps
it collects an interval snapshot of the signal planes and sweeps a
declarative **policy table** mapping conditions onto a bounded
**actuator registry**:

======================  =================================================
actuator                effect
======================  =================================================
``prefetch.deepen``     ``PSTrainStep.set_prefetch_depth(depth+1)`` (cap
                        ``FLAGS_autopilot_max_prefetch_depth``) — hide PS
                        pull latency behind more in-flight windows
``prefetch.shallow``    the deepen's revert: restore the previous depth
``wire.retreat``        ``PsClient.set_wire_dtype("f32")`` — numerics
                        trouble trumps bandwidth; re-handshakes per server
``wire.advance``        ``PsClient.set_wire_dtype("bf16")`` — bandwidth
                        blame with clean numerics earns compression back
``scaler.tighten``      ``GradScaler.tighten_growth()`` — grow the loss
                        scale 4x more slowly after a scale collapse
``resilient.restore``   ``ResilientTrainStep.restore()`` + streak reset —
                        force a known-good snapshot when non-finite
                        streaks exceed budget (no revert: a restore is
                        not undoable and needs none)
``elastic.shrink``      ``ElasticAgent.enforce_straggler_policy()`` —
                        deadline-guarded replace/shrink of a persistent
                        straggler (no revert: membership moves forward)
======================  =================================================

Robustness is the design center, not a feature:

* **hysteresis** — a policy must fire on ``FLAGS_autopilot_hysteresis``
  *consecutive* evaluation intervals before its action runs; one noisy
  interval moves nothing.
* **cooldown** — an action just taken cannot re-fire for
  ``FLAGS_autopilot_cooldown_s`` seconds (the controller's clock, which
  is injectable — tests drive it deterministically).
* **global budget** — at most ``FLAGS_autopilot_max_actions`` actions
  per ``FLAGS_autopilot_window_s`` rolling window, across all policies.
* **dry-run** — ``FLAGS_autopilot_dry_run`` computes and records every
  decision but applies nothing: the training trajectory is bitwise
  identical to autopilot-off.
* **guarded rollback** — each applied action snapshots the objective
  (interval mean step ms + bad-event count); after
  ``FLAGS_autopilot_rollback_intervals`` further evaluations the
  controller re-measures, and an action that made things worse (step
  time regressed beyond ``FLAGS_autopilot_rollback_tolerance``, or bad
  events increased) is reverted with the state its actuator returned.
* **the watcher never crashes the watched** — every actuator
  application passes the ``autopilot.act`` chaos point and every
  exception (injected or real) degrades to a counted flight event
  (``autopilot_act_errors_total``), never an exception in the train
  loop.

Every decision — taken, suppressed, reverted, errored — is a flight
event (``autopilot.action`` / ``.suppressed`` / ``.revert`` /
``.act_error``) and, when a
:class:`~paddle_tpu_torch.framework.runlog.RunLedger`
is attached, a ``kind="autopilot"`` ledger record (empty ``summary`` —
``perf_report compare`` sees the audit trail but never mistakes it for
a measured run).

Threading contract: ``tick``/``evaluate`` run on the train-loop thread
only (same single-consumer contract as ``PSTrainStep``'s prefetch
pipeline); the signal planes it reads are each internally thread-safe.

The second, offline half lives in ``tools/autotune.py``: it replays the
run ledger to search the same knob space against a measured objective
and emits a tuned profile that :func:`maybe_apply_tuned_profile` (called
from ``TrainStep``/``PSTrainStep`` construction and ``bench.py``
startup) turns into flag overrides — the runtime controller starts from
a tuned operating point instead of defaults.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch.framework import chaos, monitor
from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.framework.observability import flight

__all__ = [
    "Policy", "Actuator", "Controller", "default_policies",
    "default_actuators", "attach", "load_tuned_profile",
    "maybe_apply_tuned_profile",
]

# policy thresholds (per evaluation interval).  Absolute floors matter:
# on a clean localhost run ps_wait can dominate the *share* of a
# microsecond-scale step, and a share-only trigger would deepen
# prefetch on a run with nothing to hide.
PS_WAIT_MIN_MS = 20.0        # per-step ps_wait ms before prefetch acts
PS_WAIT_MIN_SHARE = 0.4      # ...and its share of the step
WIRE_ADVANCE_MIN_SHARE = 0.5  # stricter: advance re-risks numerics
NAN_SKIPS_RETREAT = 2        # nan skips per interval → wire retreat
CONSECUTIVE_BAD_RESTORE = 2  # non-finite streak → forced restore


class Policy:
    """One row of the policy table: ``when(signals)`` returns a reason
    string when the condition holds this interval (``None`` otherwise);
    ``action`` names the actuator to run after ``hysteresis``
    consecutive confirming intervals (``None`` → controller default)."""

    def __init__(self, name: str, action: str,
                 when: Callable[[Dict[str, Any]], Optional[str]],
                 hysteresis: Optional[int] = None):
        self.name = name
        self.action = action
        self.when = when
        self.hysteresis = hysteresis


class Actuator:
    """One registry entry: ``apply(ctl)`` mutates the target and
    returns the state ``revert(ctl, state)`` needs to undo it
    (``revert=None`` → the rollback guard skips this action);
    ``available(ctl)`` gates policies whose target isn't attached."""

    def __init__(self, name: str,
                 apply: Callable[["Controller"], Any],
                 revert: Optional[Callable[["Controller", Any], None]] = None,
                 available: Optional[Callable[["Controller"], bool]] = None):
        self.name = name
        self.apply = apply
        self.revert = revert
        self._available = available

    def available(self, ctl: "Controller") -> bool:
        return True if self._available is None else bool(
            self._available(ctl))


# -- signal helpers (pure functions of the signals dict) -----------------

def _blame_ms(sig: Dict[str, Any], cat: str) -> float:
    return float((sig.get("blame_per_step") or {}).get(cat, 0.0))


def _blame_share(sig: Dict[str, Any], cat: str) -> float:
    b = sig.get("blame_per_step") or {}
    tot = sum(b.values())
    return float(b.get(cat, 0.0)) / tot if tot > 0 else 0.0


def _numerics_trouble(sig: Dict[str, Any]) -> bool:
    return bool(sig.get("scale_collapses", 0) or sig.get("nan_skips", 0)
                or sig.get("consecutive_bad", 0))


def default_policies() -> List[Policy]:
    """The built-in policy table (see module docstring for the actuator
    each row drives)."""

    def p_deepen(s):
        w, sh = _blame_ms(s, "ps_wait"), _blame_share(s, "ps_wait")
        if w >= PS_WAIT_MIN_MS and sh >= PS_WAIT_MIN_SHARE:
            return f"ps_wait {w:.1f}ms/step, {sh:.0%} of step"
        return None

    def p_retreat(s):
        if s.get("wire_dtype") in (None, "f32"):
            return None
        if s.get("scale_collapses", 0):
            return f"{s['scale_collapses']} scale collapse(s) on bf16 wire"
        if s.get("nan_skips", 0) >= NAN_SKIPS_RETREAT:
            return f"{s['nan_skips']} nan skips on bf16 wire"
        return None

    def p_advance(s):
        if s.get("wire_dtype") != "f32" or _numerics_trouble(s):
            return None
        w, sh = _blame_ms(s, "ps_wait"), _blame_share(s, "ps_wait")
        if w >= PS_WAIT_MIN_MS and sh >= WIRE_ADVANCE_MIN_SHARE:
            return (f"ps_wait {w:.1f}ms/step, {sh:.0%} of step, "
                    f"numerics clean")
        return None

    def p_tighten(s):
        if s.get("scale_collapses", 0):
            return f"{s['scale_collapses']} scale collapse(s)"
        return None

    def p_restore(s):
        cb = s.get("consecutive_bad", 0)
        if cb >= CONSECUTIVE_BAD_RESTORE:
            return f"non-finite streak {cb}"
        return None

    def p_shrink(s):
        over = s.get("stragglers_overdue") or []
        if over:
            return "straggler(s) past deadline: " + ",".join(over)
        return None

    return [
        # numerics first: a retreat must win the interval over an
        # advance, and a restore must beat bandwidth tuning
        Policy("wire.retreat", "wire.retreat", p_retreat, hysteresis=1),
        Policy("scaler.tighten", "scaler.tighten", p_tighten,
               hysteresis=1),
        Policy("resilient.restore", "resilient.restore", p_restore,
               hysteresis=1),
        Policy("prefetch.deepen", "prefetch.deepen", p_deepen),
        Policy("wire.advance", "wire.advance", p_advance, hysteresis=3),
        Policy("elastic.shrink", "elastic.shrink", p_shrink,
               hysteresis=1),
    ]


# -- actuator implementations -------------------------------------------

def _act_deepen(ctl):
    prev = ctl.step.set_prefetch_depth(
        min(ctl.step.prefetch_depth + 1, ctl.max_prefetch_depth))
    return {"prefetch_depth": prev}


def _act_deepen_revert(ctl, state):
    ctl.step.set_prefetch_depth(int(state["prefetch_depth"]))


def _act_wire(to):
    def apply(ctl):
        return {"wire_dtype": ctl.client().set_wire_dtype(to)}
    return apply


def _act_wire_revert(ctl, state):
    ctl.client().set_wire_dtype(state["wire_dtype"])


def _act_tighten(ctl):
    return ctl.scaler.tighten_growth()


def _act_tighten_revert(ctl, state):
    ctl.scaler.restore_growth(state)


def _act_restore(ctl):
    ctl.resilient.restore()
    # restore() alone leaves the streak counting toward train.abort;
    # the forced rollback IS the recovery, so the streak restarts
    ctl.resilient.consecutive_bad = 0
    return None


def _act_shrink(ctl):
    ctl.agent.enforce_straggler_policy(ctl.straggler_deadline)
    return None


def default_actuators() -> Dict[str, Actuator]:
    can_prefetch = lambda c: c.step is not None and \
        hasattr(c.step, "set_prefetch_depth")            # noqa: E731
    can_wire = lambda c: c.client() is not None          # noqa: E731
    return {
        "prefetch.deepen": Actuator(
            "prefetch.deepen", _act_deepen, _act_deepen_revert,
            available=lambda c: can_prefetch(c) and
            c.step.prefetch_depth < c.max_prefetch_depth),
        "prefetch.shallow": Actuator(
            "prefetch.shallow",
            lambda c: {"prefetch_depth": c.step.set_prefetch_depth(
                max(0, c.step.prefetch_depth - 1))},
            _act_deepen_revert, available=can_prefetch),
        "wire.retreat": Actuator(
            "wire.retreat", _act_wire("f32"), _act_wire_revert,
            available=can_wire),
        "wire.advance": Actuator(
            "wire.advance", _act_wire("bf16"), _act_wire_revert,
            available=can_wire),
        "scaler.tighten": Actuator(
            "scaler.tighten", _act_tighten, _act_tighten_revert,
            available=lambda c: c.scaler is not None),
        "resilient.restore": Actuator(
            "resilient.restore", _act_restore, None,
            available=lambda c: c.resilient is not None),
        "elastic.shrink": Actuator(
            "elastic.shrink", _act_shrink, None,
            available=lambda c: c.agent is not None),
    }


class Controller:
    """The runtime half of the autopilot (see module docstring).

    Targets are attached explicitly — ``step`` (a ``PSTrainStep``, or
    anything with ``prefetch_depth``/``set_prefetch_depth``),
    ``client`` (``PsClient``; resolved from
    ``step.embedding.table.client`` when omitted), ``scaler``
    (``GradScaler``), ``resilient`` (``ResilientTrainStep``), ``agent``
    (``ElasticAgent``) — and a missing target simply disables the
    policies that would drive it.  ``blame_source`` is a zero-arg
    callable returning a ``framework.blame`` result (or its
    ``summary()`` dict) for the *current* interval; alternatively push
    one with :meth:`note_blame`.  ``ledger`` is a
    ``runlog.RunLedger`` the audit records append to.

    All decision state is private to the train-loop thread; ``clock``
    (default ``time.monotonic``) is the ONLY time source decisions
    consult, so a test driving a fake clock replays bit-identically.
    """

    def __init__(self, *, step=None, client=None, scaler=None,
                 resilient=None, agent=None,
                 blame_source: Optional[Callable[[], dict]] = None,
                 ledger=None,
                 policies: Optional[List[Policy]] = None,
                 actuators: Optional[Dict[str, Actuator]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 dry_run: Optional[bool] = None,
                 interval_steps: Optional[int] = None,
                 hysteresis: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 max_actions: Optional[int] = None,
                 window_s: Optional[float] = None,
                 rollback_intervals: Optional[int] = None,
                 rollback_tolerance: Optional[float] = None,
                 max_prefetch_depth: Optional[int] = None,
                 straggler_deadline: Optional[float] = None):
        self.step = step
        self._client = client
        self.scaler = scaler
        self.resilient = resilient
        self.agent = agent
        self.blame_source = blame_source
        self.ledger = ledger
        self.policies = default_policies() if policies is None \
            else list(policies)
        self.actuators = default_actuators() if actuators is None \
            else dict(actuators)
        self.clock = clock or time.monotonic

        def _f(v, name, cast):
            return cast(flag(name)) if v is None else cast(v)
        self.dry_run = _f(dry_run, "autopilot_dry_run", bool)
        self.interval_steps = max(1, _f(
            interval_steps, "autopilot_interval_steps", int))
        self.hysteresis = max(1, _f(
            hysteresis, "autopilot_hysteresis", int))
        self.cooldown_s = _f(cooldown_s, "autopilot_cooldown_s", float)
        self.max_actions = _f(max_actions, "autopilot_max_actions", int)
        self.window_s = _f(window_s, "autopilot_window_s", float)
        self.rollback_intervals = max(1, _f(
            rollback_intervals, "autopilot_rollback_intervals", int))
        self.rollback_tolerance = _f(
            rollback_tolerance, "autopilot_rollback_tolerance", float)
        self.max_prefetch_depth = _f(
            max_prefetch_depth, "autopilot_max_prefetch_depth", int)
        self.straggler_deadline = _f(
            straggler_deadline, "autopilot_straggler_deadline", float)

        # decision state (train-loop thread only)
        self._ticks = 0
        self._evals = 0
        self._streak: Dict[str, int] = {}
        self._last_action_t: Dict[str, float] = {}
        self._action_times: List[float] = []
        self._pending: List[dict] = []       # applied, awaiting verdict
        self._noted_blame: Optional[dict] = None
        # interval baselines for cumulative counters/histograms
        self._prev_totals: Dict[str, int] = dict(flight.kind_totals())
        self._prev_hist: Dict[str, tuple] = {}
        self._prev_stats: Dict[str, float] = {}
        self._prime_counters()
        self.decisions: List[dict] = []      # full audit, test-readable

    # -- target resolution ----------------------------------------------
    def client(self):
        """The PS client actuators flip: the explicit one, else the one
        behind ``step.embedding.table.client``."""
        if self._client is not None:
            return self._client
        table = getattr(getattr(self.step, "embedding", None),
                        "table", None)
        return getattr(table, "client", None)

    def note_blame(self, result: Optional[dict]):
        """Push this interval's blame (a ``compute_blame`` result or a
        ``blame.summary()`` dict); consumed by the next evaluation."""
        self._noted_blame = result

    # -- signal collection ----------------------------------------------
    def _prime_counters(self):
        for name in ("health_anomalies_total",):
            self._prev_stats[name] = float(
                monitor.get_stat(name) or 0)
        for hname, h in monitor.all_histograms().items():
            self._prev_hist[hname] = (h["count"], h["sum"]) \
                if isinstance(h, dict) else (h.count, h.sum)

    def _hist_delta(self, name: str) -> tuple:
        h = monitor.get_histogram(name)
        pc, ps = self._prev_hist.get(name, (0, 0.0))
        d = (h.count - pc, h.sum - ps)
        self._prev_hist[name] = (h.count, h.sum)
        return d

    def _stat_delta(self, name: str) -> float:
        cur = float(monitor.get_stat(name) or 0)
        d = cur - self._prev_stats.get(name, 0.0)
        self._prev_stats[name] = cur
        return d

    def _flight_delta(self, kind: str, totals: Dict[str, int]) -> int:
        d = totals.get(kind, 0) - self._prev_totals.get(kind, 0)
        return d

    @staticmethod
    def _norm_blame(raw: Optional[dict]) -> Dict[str, float]:
        """Either shape → per-step ms by category."""
        if not raw:
            return {}
        if "per_step_ms" in raw:             # compute_blame result
            return {k: float(v) for k, v in raw["per_step_ms"].items()}
        out = {}
        for k, v in raw.items():             # summary() dict
            if k.startswith("blame_") and k.endswith("_ms"):
                out[k[len("blame_"):-len("_ms")]] = float(v)
        return out

    def _collect(self) -> Dict[str, Any]:
        totals = dict(flight.kind_totals())
        sc, ss = self._hist_delta("train_step_ms")
        rpc_c, rpc_s = 0, 0.0
        for name in monitor.all_histograms():
            if name.startswith("ps_client_rpc_ms_"):
                c, s = self._hist_delta(name)
                rpc_c += c
                rpc_s += s
        blame_raw = self._noted_blame
        self._noted_blame = None
        if self.blame_source is not None:
            try:
                blame_raw = self.blame_source()
            except Exception:                # noqa: BLE001 — a broken
                monitor.stat_add(           # signal plane must not
                    "autopilot_signal_errors_total")  # stop the sweep
                blame_raw = None
        sig = {
            "steps": sc,
            "step_ms": (ss / sc) if sc else None,
            "rpc_ms": (rpc_s / rpc_c) if rpc_c else None,
            "rpc_count": rpc_c,
            "anomalies": self._stat_delta("health_anomalies_total"),
            "scale_collapses": self._flight_delta(
                "numerics.scale_collapse", totals),
            "nan_skips": self._flight_delta("train.nan_skip", totals),
            "consecutive_bad": getattr(
                self.resilient, "consecutive_bad", 0),
            "blame_per_step": self._norm_blame(blame_raw),
            "wire_dtype": getattr(self.client(), "wire_dtype", None),
            "prefetch_depth": getattr(self.step, "prefetch_depth",
                                      None),
            "stragglers_overdue": (
                self.agent.straggler_overdue(self.straggler_deadline)
                if self.agent is not None else []),
        }
        self._prev_totals = totals
        return sig

    # -- objective / rollback guard --------------------------------------
    @staticmethod
    def _objective(sig: Dict[str, Any]) -> tuple:
        bad = (sig.get("scale_collapses", 0) + sig.get("nan_skips", 0)
               + (1 if sig.get("consecutive_bad", 0) else 0))
        return (sig.get("step_ms"), bad)

    def _worse(self, base: tuple, sig: Dict[str, Any]) -> bool:
        b_ms, b_bad = base
        c_ms, c_bad = self._objective(sig)
        if c_bad > b_bad:
            return True
        return (b_ms is not None and c_ms is not None and
                c_ms > b_ms * (1.0 + self.rollback_tolerance))

    # -- driving ----------------------------------------------------------
    def tick(self) -> List[dict]:
        """Call once per train step; runs :meth:`evaluate` every
        ``interval_steps`` ticks.  Returns the decisions made this
        tick (usually ``[]``)."""
        self._ticks += 1
        if self._ticks % self.interval_steps == 0:
            return self.evaluate()
        return []

    def evaluate(self) -> List[dict]:
        """One evaluation interval: collect signals, settle pending
        rollback verdicts, sweep the policy table.  Never raises."""
        now = self.clock()
        self._evals += 1
        sig = self._collect()
        decisions: List[dict] = []

        # 1. verdicts on previously applied actions
        for p in list(self._pending):
            p["evals_left"] -= 1
            if p["evals_left"] > 0:
                continue
            self._pending.remove(p)
            if self._worse(p["baseline"], sig):
                self._revert(p, decisions)

        # 2. policy sweep
        for pol in self.policies:
            act = self.actuators.get(pol.action)
            if act is None or not act.available(self):
                self._streak[pol.name] = 0
                continue
            try:
                reason = pol.when(sig)
            except Exception:                # noqa: BLE001 — one bad
                monitor.stat_add(           # policy must not stop the
                    "autopilot_signal_errors_total")   # sweep
                reason = None
            if not reason:
                self._streak[pol.name] = 0
                continue
            streak = self._streak.get(pol.name, 0) + 1
            self._streak[pol.name] = streak
            need = self.hysteresis if pol.hysteresis is None \
                else pol.hysteresis
            if streak < need:
                self._suppress(pol, f"hysteresis {streak}/{need}",
                               reason, decisions)
                continue
            last = self._last_action_t.get(pol.action)
            if last is not None and now - last < self.cooldown_s:
                self._suppress(
                    pol, f"cooldown {now - last:.0f}s/"
                    f"{self.cooldown_s:.0f}s", reason, decisions)
                continue
            self._action_times = [t for t in self._action_times
                                  if now - t <= self.window_s]
            if len(self._action_times) >= self.max_actions:
                self._suppress(
                    pol, f"budget {len(self._action_times)}/"
                    f"{self.max_actions} per {self.window_s:.0f}s",
                    reason, decisions)
                continue
            self._take(pol, act, reason, sig, now, decisions)

        self.decisions.extend(decisions)
        return decisions

    # -- decision recording ----------------------------------------------
    def _decision(self, kind: str, policy: str, action: str,
                  reason: str) -> dict:
        return {"eval": self._evals, "step": self._ticks,
                "policy": policy, "action": action, "kind": kind,
                "reason": reason, "dry_run": self.dry_run}

    def _record(self, d: dict, severity: str):
        ev_kind = {"taken": "autopilot.action",
                   "suppressed": "autopilot.suppressed",
                   "reverted": "autopilot.revert",
                   "error": "autopilot.act_error"}[d["kind"]]
        # "kind" is the flight event's own field; the decision kind
        # travels as "decision"
        attrs = {("decision" if k == "kind" else k): v
                 for k, v in d.items()}
        flight.record(ev_kind, severity=severity, **attrs)
        if self.ledger is not None:
            from paddle_tpu_torch.framework import runlog
            self.ledger.append({
                "schema_version": runlog.SCHEMA_VERSION,
                "kind": "autopilot", "label": d["policy"],
                "run_id": runlog._run_id(), "ts": time.time(),
                "meta": runlog.run_meta(),
                # empty summary: perf_report series see no signals in
                # these records, so the audit trail never perturbs a
                # compare over the same ledger
                "summary": {}, "action": dict(d)})

    def _suppress(self, pol: Policy, why: str, reason: str,
                  decisions: List[dict]):
        d = self._decision("suppressed", pol.name, pol.action,
                           f"{reason}; {why}")
        monitor.stat_add("autopilot_suppressed_total")
        self._record(d, "info")
        decisions.append(d)

    def _take(self, pol: Policy, act: Actuator, reason: str,
              sig: Dict[str, Any], now: float, decisions: List[dict]):
        self._streak[pol.name] = 0
        # dry-run books the action too: the decision SEQUENCE (with
        # cooldowns and budget) matches what a live run would do
        self._last_action_t[pol.action] = now
        self._action_times.append(now)
        d = self._decision("taken", pol.name, pol.action, reason)
        if self.dry_run:
            monitor.stat_add("autopilot_actions_total")
            self._record(d, "info")
            decisions.append(d)
            return
        try:
            # fire-and-forget by contract: a faulting actuator degrades to the
            # counted act_error path below, never a crashed train loop
            chaos.fault_point("autopilot.act",
                              meta={"action": pol.action})
            state = act.apply(self)
        except Exception as e:               # noqa: BLE001 — the
            # watcher never crashes the watched: injected or real,
            # an actuator fault is a counted event, not an exception
            # in the train loop
            monitor.stat_add("autopilot_act_errors_total")
            d["kind"] = "error"
            d["error"] = f"{type(e).__name__}: {e}"
            self._record(d, "error")
            decisions.append(d)
            return
        monitor.stat_add("autopilot_actions_total")
        if act.revert is not None:
            self._pending.append({
                "decision": d, "state": state,
                "baseline": self._objective(sig),
                "evals_left": self.rollback_intervals})
        self._record(d, "warn" if pol.name.startswith(
            ("wire.retreat", "scaler", "resilient", "elastic"))
            else "info")
        decisions.append(d)

    def _revert(self, pending: dict, decisions: List[dict]):
        src = pending["decision"]
        act = self.actuators.get(src["action"])
        d = self._decision(
            "reverted", src["policy"], src["action"],
            f"objective worsened after {src['action']} "
            f"(taken at eval {src['eval']})")
        try:
            # same contract as the apply site
            chaos.fault_point("autopilot.act",
                              meta={"action": src["action"],
                                    "revert": True})
            act.revert(self, pending["state"])
        except Exception as e:               # noqa: BLE001 — same
            monitor.stat_add("autopilot_act_errors_total")  # contract
            d["kind"] = "error"              # as apply
            d["error"] = f"{type(e).__name__}: {e}"
            self._record(d, "error")
            decisions.append(d)
            return
        monitor.stat_add("autopilot_reverts_total")
        self._record(d, "warn")
        decisions.append(d)

    def snapshot(self) -> dict:
        """Controller state for reports/tests: counts by decision kind
        plus the knobs currently in force."""
        kinds: Dict[str, int] = {}
        for d in self.decisions:
            kinds[d["kind"]] = kinds.get(d["kind"], 0) + 1
        return {"ticks": self._ticks, "evals": self._evals,
                "decisions": kinds, "pending": len(self._pending),
                "dry_run": self.dry_run,
                "prefetch_depth": getattr(self.step, "prefetch_depth",
                                          None),
                "wire_dtype": getattr(self.client(), "wire_dtype",
                                      None)}


def attach(**targets) -> Optional[Controller]:
    """Build a :class:`Controller` over ``targets`` when
    ``FLAGS_autopilot`` is set; ``None`` (autopilot off) otherwise.
    The train loop calls ``ctl.tick()`` per step if non-``None``."""
    if not flag("autopilot"):
        return None
    return Controller(**targets)


# -- tuned startup profile (the offline half's output) -------------------

_applied_profiles: set = set()


def load_tuned_profile(path: str) -> dict:
    """Read + validate a ``tools/autotune.py`` profile: a JSON object
    ``{"schema_version": 1, "objective": ..., "knobs": {...}}``.
    Raises on malformed input — callers that must not raise go through
    :func:`maybe_apply_tuned_profile`."""
    with open(path, "r", encoding="utf-8") as f:
        prof = json.load(f)
    if not isinstance(prof, dict) or \
            not isinstance(prof.get("knobs"), dict):
        raise ValueError(f"not a tuned profile: {path}")
    if int(prof.get("schema_version", 0)) != 1:
        raise ValueError(
            f"unknown profile schema {prof.get('schema_version')!r}")
    return prof


def maybe_apply_tuned_profile(source: str = "") -> Optional[dict]:
    """Apply ``FLAGS_autotune_profile`` (if set) exactly once per
    process: translate its knobs into flag overrides (ps_prefetch_depth,
    ps_wire_dtype, zero_wire_dtype) via ``set_flags`` so every
    construction that follows starts from the tuned operating point.
    ``source`` labels the call site in the flight event.  Never raises:
    a missing/corrupt profile degrades to a counted
    ``autopilot.profile_error`` flight event and default knobs."""
    path = str(flag("autotune_profile") or "")
    if not path or path in _applied_profiles:
        return None
    _applied_profiles.add(path)
    try:
        prof = load_tuned_profile(path)
        knobs = prof["knobs"]
        updates: Dict[str, Any] = {}
        if "prefetch_depth" in knobs:
            updates["ps_prefetch_depth"] = int(knobs["prefetch_depth"])
        if "wire_dtype" in knobs:
            wd = str(knobs["wire_dtype"])
            updates["ps_wire_dtype"] = wd
            updates["zero_wire_dtype"] = wd
        # batch_size is consumed by the harness (bench reads the knob
        # itself) — flags carry no batch size to override here
        if updates:
            set_flags(updates)
        flight.record("autopilot.profile_applied", severity="info",
                      path=path, source=source,
                      knobs={k: knobs[k] for k in sorted(knobs)})
        return prof
    except Exception as e:                   # noqa: BLE001 — startup
        # tuning is advisory: a bad profile must never stop training
        monitor.stat_add("autopilot_profile_errors_total")
        flight.record("autopilot.profile_error", severity="warn",
                      path=path, source=source,
                      error=f"{type(e).__name__}: {e}")
        return None
