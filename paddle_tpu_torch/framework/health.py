"""Perf health plane (port of paddle_tpu/framework/health.py): compile and
device-memory observability with streaming anomaly detection.

* **Compile observability.**  ``jit.StaticFunction``, ``jit.TrainStep``
  and ``distributed.ps.PSTrainStep`` report every signature lookup here,
  keyed as the reference keys its caches.  Eager PyTorch compiles
  nothing, so a "compile" is the first call under a signature the site
  has not seen: :func:`classify_recompile` names its cause by diffing
  the new signature against the seen ones (``new_signature`` /
  ``shape_change`` / ``dtype_change`` / ``static_arg_change``) and
  :func:`timed_compile` times that first call into ``compile_ms``.  For
  the same sequence of calls :func:`compile_report` gives the reference's
  counts and causes (``StaticFunction``'s ``torch.export`` capture is a
  real compile, and its ``to_static:<name>`` site counts it).  Past the
  warm-up calls, recompiles count as steady-state, and K of them at one
  site record a ``health.compile_storm`` flight event.

* **Device-memory observability.**  :class:`MemoryTracker` samples the
  live bytes into ``device_mem_live_bytes`` / ``device_mem_peak_bytes``
  with per-tag gauges (``device_mem_<tag>_bytes``: params, opt_state,
  buffers from the train steps) and a ``health.mem_watermark`` flight
  event when the peak grows by ``watermark_frac``.  Where CUDA is in use
  the bytes are the caching allocator's: ``torch.cuda.memory_allocated``
  (the live tensors' blocks, rounded up to the allocator's 512-byte
  granularity, on the current card only) and, for the peak, the larger
  of the samples and ``torch.cuda.max_memory_allocated`` (which also
  sees the peaks between samples); no device synchronisation.  On the
  CPU, which keeps no such count, a sample sums the distinct storages of
  the live tensors the garbage collector tracks (a view is not counted
  twice), a walk only a due sample pays for.  The reference sums the
  ``nbytes`` of ``jax.live_arrays()``: the logical sizes of every live
  array on every device, views and donated buffers as XLA keeps them.
  ``profile(path)`` writes ``torch.cuda.memory._snapshot()``.

* **Streaming anomaly detection.**  :class:`Detector`: an EWMA and a
  robust MAD z-score over a sliding window of one scalar signal (step
  time, prefetch miss rate, ...), deterministic in the value sequence.
  Anomalies feed the flight recorder (``health.anomaly``) and export as
  ``health_anomalies_total`` / ``health_anomaly_<signal>_total``.

Arming: ``watch(signal)``, or ``FLAGS_health_detectors`` (``"default"``
arms :data:`DEFAULT_SIGNALS`, a JSON object a custom set).  Nothing
armed, :func:`observe` is a dict check.  The ``health.detector`` chaos
point fires at the head of every observation; an injected error is
swallowed and counted (``health_observe_errors_total``).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.framework import chaos, monitor
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.framework.observability import flight, tracer

__all__ = ["Anomaly", "Detector", "HealthMonitor", "MemoryTracker",
           "memory", "watch", "observe", "enabled", "snapshot", "reset",
           "classify_recompile", "note_compile", "note_cache_hit",
           "compile_report", "maybe_sample_memory", "DEFAULT_SIGNALS",
           "RECOMPILE_CAUSES"]


# ---------------------------------------------------------------------------
# streaming anomaly detection
# ---------------------------------------------------------------------------

class Anomaly:
    """One flagged observation: the value, its robust z-score, and the
    baseline (window median / MAD scale) it was judged against."""

    __slots__ = ("signal", "value", "z", "median", "scale", "index", "ts")

    def __init__(self, signal: str, value: float, z: float, median: float,
                 scale: float, index: int, ts: float):
        self.signal = signal
        self.value = value
        self.z = z
        self.median = median
        self.scale = scale
        self.index = index
        self.ts = ts

    def to_dict(self) -> dict:
        return {"signal": self.signal, "value": round(self.value, 6),
                "z": round(self.z, 3), "median": round(self.median, 6),
                "scale": round(self.scale, 6), "index": self.index,
                "ts": self.ts}

    def __repr__(self):
        return (f"Anomaly({self.signal}: value={self.value:.4g} "
                f"z={self.z:.1f} median={self.median:.4g})")


class Detector:
    """EWMA + robust MAD z-score over one scalar signal stream.

    Each :meth:`update` folds the value into an EWMA (trend readout)
    and — once ``warmup`` baseline samples exist — scores it against
    the sliding window's median with a MAD scale:
    ``z = 0.6745 * (v - median) / max(MAD, min_mad,
    rel_floor * |median|)``.  The floors keep a near-constant baseline
    (MAD → 0) from flagging benign jitter: on a dead-flat stream only
    a deviation larger than ``rel_floor`` of the level (or ``min_mad``
    absolutely) can trip.  ``|z| >= z_threshold`` flags an
    :class:`Anomaly`.

    Anomalous values never enter the baseline window — a latency storm
    must not teach the detector that storms are normal — but
    ``max_consecutive`` consecutive anomalies force a **re-baseline**
    (window cleared, fresh warmup): a genuine level shift is adopted
    after a bounded alarm burst instead of alarming forever.

    Deterministic: behavior depends only on the value sequence.  The
    injectable ``clock`` (``elastic.DictStore`` discipline) stamps
    anomaly timestamps and never gates detection.
    """

    def __init__(self, signal: str, warmup: Optional[int] = None,
                 window: int = 64, z_threshold: Optional[float] = None,
                 ewma_alpha: float = 0.2, min_mad: float = 1e-9,
                 rel_floor: float = 0.05, max_consecutive: int = 64,
                 clock=None):
        self.signal = signal
        self.warmup = int(flag("health_warmup")) if warmup is None \
            else int(warmup)
        if self.warmup < 4:
            raise ValueError("Detector warmup must be >= 4 samples "
                             "(a 1-sample baseline flags everything)")
        self.window = int(window)
        self.z_threshold = float(flag("health_z_threshold")) \
            if z_threshold is None else float(z_threshold)
        self.ewma_alpha = float(ewma_alpha)
        self.min_mad = float(min_mad)
        self.rel_floor = float(rel_floor)
        self.max_consecutive = int(max_consecutive)
        self.clock = clock or time.time
        self._values: deque = deque(maxlen=self.window)
        self._lock = threading.Lock()    # PS fan-out threads share the
        self._warm_left = self.warmup    # ps_rpc_ms detector
        self.n = 0
        self.anomalies = 0
        self.consecutive = 0
        self.rebaselines = 0
        self.ewma: Optional[float] = None
        self.last: Optional[float] = None
        self.last_z = 0.0

    def update(self, value) -> Optional[Anomaly]:
        """Score one observation; returns the :class:`Anomaly` when it
        trips, else None.  Thread-safe: concurrent feeders (the PS
        client's RPC fan-out threads) serialize on the detector.

        A NON-FINITE observation (a NaN grad norm on a blown-up step)
        is an anomaly by definition — flagged immediately, even during
        warmup, with ``z=inf`` — and never folds into the EWMA or the
        baseline window (one NaN would otherwise poison both
        forever)."""
        v = float(value)
        with self._lock:
            self.n += 1
            self.last = v
            if not np.isfinite(v):
                self.anomalies += 1
                self.consecutive += 1
                # median BEFORE any rebaseline clear: the anomaly must
                # report the baseline it was judged against
                med = float(np.median(np.asarray(self._values,
                                                 np.float64))) \
                    if self._values else 0.0
                if self.consecutive >= self.max_consecutive:
                    self._values.clear()
                    self._warm_left = self.warmup
                    self.consecutive = 0
                    self.rebaselines += 1
                self.last_z = float("inf")
                return Anomaly(self.signal, v, float("inf"), med, 0.0,
                               self.n, self.clock())
            self.ewma = v if self.ewma is None else \
                self.ewma_alpha * v + (1.0 - self.ewma_alpha) * self.ewma
            if self._warm_left > 0:
                self._warm_left -= 1
                self._values.append(v)
                # a clean sample breaks any non-finite anomaly streak
                # even during warmup (the z=inf rule can flag here):
                # isolated NaNs must not ratchet toward a rebaseline
                self.consecutive = 0
                return None
            vals = np.asarray(self._values, np.float64)
            med = float(np.median(vals))
            mad = float(np.median(np.abs(vals - med)))
            scale = max(mad, self.min_mad, self.rel_floor * abs(med))
            z = 0.6745 * (v - med) / scale
            self.last_z = z
            if abs(z) < self.z_threshold:
                self.consecutive = 0
                self._values.append(v)
                return None
            self.anomalies += 1
            self.consecutive += 1
            if self.consecutive >= self.max_consecutive:
                # a sustained shift is the new normal: re-baseline
                # instead of alarming forever (bounded alarm burst by
                # design)
                self._values.clear()
                self._warm_left = self.warmup
                self.consecutive = 0
                self.rebaselines += 1
            return Anomaly(self.signal, v, z, med, scale, self.n,
                           self.clock())

    def last_value(self) -> Optional[float]:
        """Most recent observed value, or ``None`` before the first
        :meth:`observe` — the read half consumers (autopilot policies)
        use instead of reaching into detector internals."""
        with self._lock:
            return self.last

    def baseline(self) -> Optional[float]:
        """Current robust baseline: the rolling-window median the z
        score is computed against, or the EWMA while still warming
        (too few samples for a median), or ``None`` before any data."""
        with self._lock:
            if self._values:
                return float(np.median(np.asarray(self._values,
                                                  np.float64)))
            return self.ewma

    def reset(self) -> None:
        """Forget everything: window, EWMA, warmup progress, and all
        counters — equivalent to a freshly constructed detector.
        Distinct from the automatic rebaseline (which keeps lifetime
        counters); callers use this at deliberate regime changes, e.g.
        after an autopilot action rewrites the knob the signal
        measures."""
        with self._lock:
            self._values.clear()
            self._warm_left = self.warmup
            self.ewma = None
            self.last = None
            self.last_z = 0.0
            self.n = 0
            self.anomalies = 0
            self.consecutive = 0
            self.rebaselines = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"n": self.n, "anomalies": self.anomalies,
                    "consecutive": self.consecutive,
                    "rebaselines": self.rebaselines,
                    "warming": self._warm_left > 0,
                    "ewma": None if self.ewma is None
                    else round(self.ewma, 6),
                    "last": None if self.last is None
                    else round(self.last, 6),
                    "last_z": round(self.last_z, 3),
                    "z_threshold": self.z_threshold}


#: the built-in signal set FLAGS_health_detectors="default" arms —
#: exactly the streams the train/transport/ingest tiers feed
DEFAULT_SIGNALS: Dict[str, dict] = {
    # per-step wall time (TrainStep / PSTrainStep __call__).  The wide
    # relative floor absorbs host-side dispatch jitter on real (tens
    # of ms+) steps; the absolute ms floor keeps sub-ms CPU baselines
    # from flagging scheduler noise — only a multiple-of-baseline /
    # tens-of-ms step (recompile, stall, storm) trips
    "train_step_ms": {"rel_floor": 0.25, "min_mad": 5.0},
    # client-side PS RPC latency, every op (TransportStats.record);
    # same floor rationale — localhost RPCs are sub-ms and jitter by
    # whole ms under load, a real latency fault is tens of ms
    "ps_rpc_ms": {"rel_floor": 0.25, "min_mad": 5.0},
    # ingest plane consumer stall share (IngestPipeline._note_wait)
    "input_stall_pct": {"min_mad": 1.0},
    # 0/1 stream per consumed prefetch (PSTrainStep._consume_prefetch);
    # the floors make a single post-warmup miss a detectable event on
    # an all-hit baseline without alarming a mixed one
    "ps_prefetch_miss": {"min_mad": 0.05, "z_threshold": 10.0},
    # model-numerics drift signals (framework/numerics.py publish, fed
    # only when FLAGS_numerics arms the in-jit stats; a non-finite
    # value flags instantly via the z=inf rule, and provenance names
    # the leaf).  The wide relative floor absorbs the natural decay of
    # grad norms over a healthy run; a multiple-of-baseline spike (10x
    # grad blow-up, lr accident, loss-scale overflow) trips the step
    # it lands
    "grad_norm": {"rel_floor": 0.5, "min_mad": 1e-9},
    "update_ratio": {"rel_floor": 0.5, "min_mad": 1e-9},
}


class HealthMonitor:
    """Registry of named-signal detectors — the plane's front door.

    ``watch(signal)`` arms a detector (idempotent); ``observe(signal,
    value)`` scores an observation.  Unwatched signals cost a dict
    lookup.  Every anomaly feeds the flight recorder
    (``health.anomaly``) and the monitor counters
    (``health_anomalies_total`` + ``health_anomaly_<signal>_total``).

    The ``health.detector`` chaos fault point fires at the head of
    every observation; an injected error is swallowed and counted
    (``health_observe_errors_total``) — the watcher must never crash
    the training loop it watches (``mode="latency"`` models a slow
    detector the loop simply absorbs).
    """

    def __init__(self, clock=None):
        self.clock = clock
        self._detectors: Dict[str, Detector] = {}
        self._lock = threading.Lock()
        self._checked_flags = False

    # -- arming -------------------------------------------------------------
    def watch(self, signal: str, **detector_kwargs) -> Detector:
        """Arm a detector for ``signal`` (idempotent: an existing
        detector is returned unchanged — re-watching must not wipe a
        live baseline)."""
        with self._lock:
            det = self._detectors.get(signal)
            if det is None:
                if "clock" not in detector_kwargs and \
                        self.clock is not None:
                    detector_kwargs["clock"] = self.clock
                det = self._detectors[signal] = Detector(
                    signal, **detector_kwargs)
            return det

    def arm_from_flags(self, force: bool = False):
        """Arm from ``FLAGS_health_detectors`` (lazy, chaos-style, so a
        launcher arms a whole child tree via the environment):
        ``"default"``/``"1"``/``"auto"`` arms :data:`DEFAULT_SIGNALS`,
        a JSON object ``{"signal": {kwargs}}`` arms a custom set,
        empty leaves the plane off.

        A malformed value (typo'd JSON, unknown detector kwarg) must
        not crash the caller: the arming is lazy, so the first
        :meth:`observe` runs from inside a train step — the
        watcher-never-crashes-watched contract covers config typos
        too.  The error is recorded (``health_config_errors_total`` +
        a ``health.config_error`` flight event) and the plane stays
        off."""
        if self._checked_flags and not force:
            return
        self._checked_flags = True
        raw = str(flag("health_detectors") or "").strip()
        if not raw:
            return
        try:
            if raw.lower() in ("default", "auto", "1", "true"):
                spec: Dict[str, dict] = DEFAULT_SIGNALS
            else:
                spec = json.loads(raw)
            for signal, kw in spec.items():
                self.watch(signal, **dict(kw))
        except Exception as e:          # noqa: BLE001 — config, not code
            monitor.stat_add("health_config_errors_total")
            flight.record("health.config_error", severity="error",
                          flag="health_detectors", value=raw[:200],
                          error=repr(e))

    def detectors(self) -> Dict[str, Detector]:
        with self._lock:
            return dict(self._detectors)

    @property
    def enabled(self) -> bool:
        if not self._checked_flags:
            self.arm_from_flags()
        return bool(self._detectors)

    # -- observation --------------------------------------------------------
    def observe(self, signal: str, value) -> Optional[Anomaly]:
        """Score ``value`` against the ``signal`` detector; no-op (None)
        when the signal is unwatched."""
        if not self._checked_flags:
            self.arm_from_flags()
        try:
            chaos.fault_point("health.detector",
                              meta={"signal": signal})
        except chaos.InjectedFault:
            # the watcher must never crash the watched: swallow, count
            monitor.stat_add("health_observe_errors_total")
            return None
        det = self._detectors.get(signal)
        if det is None:
            return None
        anomaly = det.update(value)
        if anomaly is not None:
            monitor.stat_add("health_anomalies_total")
            monitor.stat_add(f"health_anomaly_{signal}_total")
            flight.record("health.anomaly", severity="warn",
                          signal=signal, value=round(anomaly.value, 6),
                          z=round(anomaly.z, 3),
                          median=round(anomaly.median, 6),
                          index=anomaly.index)
        return anomaly

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able state of every detector plus the compile sites —
        what the PS ``stat`` op's ``health`` field and
        ``tools/health_check.py`` render."""
        dets = self.detectors()
        return {"signals": {s: d.snapshot() for s, d in dets.items()},
                "anomalies_total": sum(d.anomalies for d in dets.values()),
                "compile": compile_report()}

    def reset(self):
        """Drop every detector and pin flag arming off until the next
        explicit :meth:`arm_from_flags` — each test starts here."""
        with self._lock:
            self._detectors.clear()
            self._checked_flags = True


_monitor = HealthMonitor()


def watch(signal: str, **detector_kwargs) -> Detector:
    """Arm a detector on the process-wide health monitor."""
    return _monitor.watch(signal, **detector_kwargs)


def observe(signal: str, value) -> Optional[Anomaly]:
    """Feed one observation to the process-wide health monitor."""
    return _monitor.observe(signal, value)


def enabled() -> bool:
    """True when any detector is armed (flag arming counted)."""
    return _monitor.enabled


def snapshot() -> dict:
    """Process-wide health state (detectors + compile sites)."""
    return _monitor.snapshot()


def reset():
    """Reset detectors, compile sites, and the memory tracker — the
    per-test clean slate (counters in the monitor registry are owned by
    ``monitor.reset_all_stats`` as usual)."""
    _monitor.reset()
    with _sites_lock:
        _sites.clear()
    memory.reset()


# ---------------------------------------------------------------------------
# compile observability
# ---------------------------------------------------------------------------

RECOMPILE_CAUSES = ("new_signature", "shape_change", "dtype_change",
                    "static_arg_change")

_DTYPE_NAMES = ("float", "bfloat", "int", "uint", "bool", "complex")


def _is_dtype_str(v) -> bool:
    if not isinstance(v, str):
        return False
    return v.rstrip("0123456789") in _DTYPE_NAMES


def _sig_diff(a, b, kinds: set) -> bool:
    """Walk two signature trees in parallel, collecting difference
    kinds into ``kinds`` ({"shape", "dtype", "static"}).  Returns False
    when the trees are structurally incomparable (different arity or
    leaf classes) — that is a wholly new signature, not a mutation."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        # a (tag/name, value) pair with equal string heads is a STATIC
        # leaf — ("S", v) from _sig_of, or a to_static (kwarg, value)
        # pair: any value difference, even a tuple of ints that would
        # otherwise read as a shape (e.g. stride=(2,2) -> (2,3)), is a
        # static-arg change, never a phantom shape change
        if len(a) == 2 and len(b) == 2 and isinstance(a[0], str) \
                and isinstance(b[0], str):
            if a[0] != b[0]:
                return False
            if a[1] != b[1]:
                kinds.add("static")
            return True
        # a tuple of ints is a shape; compare it as ONE leaf
        if a != b and all(isinstance(x, int) for x in a) \
                and all(isinstance(x, int) for x in b):
            kinds.add("shape")
            return True
        if len(a) != len(b):
            return False
        return all(_sig_diff(x, y, kinds) for x, y in zip(a, b))
    if isinstance(a, tuple) or isinstance(b, tuple):
        return False
    if a == b:
        return True
    if _is_dtype_str(a) and _is_dtype_str(b):
        kinds.add("dtype")
        return True
    kinds.add("static")
    return True


def classify_recompile(sig, cached_sigs) -> str:
    """Attribute a signature-cache miss to its cause by diffing ``sig``
    against every cached signature and keeping the closest comparable
    one: ``static_arg_change`` > ``dtype_change`` > ``shape_change``
    (a static-arg flip is reported even when it dragged shapes along —
    it is the actionable cause); no comparable cached signature (or an
    empty cache) is a ``new_signature``."""
    best: Optional[set] = None
    for cached in cached_sigs:
        kinds: set = set()
        if not _sig_diff(sig, cached, kinds) or not kinds:
            continue
        if best is None or len(kinds) < len(best):
            best = kinds
    if best is None:
        return "new_signature"
    if "static" in best:
        return "static_arg_change"
    if "dtype" in best:
        return "dtype_change"
    return "shape_change"


class _CompileSite:
    __slots__ = ("name", "calls", "compiles", "steady_recompiles",
                 "causes", "last_cause", "compile_ms_total")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.compiles = 0
        self.steady_recompiles = 0
        self.causes: Dict[str, int] = {}
        self.last_cause: Optional[str] = None
        self.compile_ms_total = 0.0


_sites: Dict[str, _CompileSite] = {}
_sites_lock = threading.Lock()


def _site(name: str) -> _CompileSite:
    with _sites_lock:
        s = _sites.get(name)
        if s is None:
            s = _sites[name] = _CompileSite(name)
        return s


def note_cache_hit(site: str):
    """A signature-cache hit at ``site`` (one per non-compiling call)."""
    s = _site(site)
    s.calls += 1
    monitor.stat_add("jit_cache_hits_total")


def note_compile(site: str, cause: str, compile_ms: float):
    """A signature-cache miss at ``site``: count the compile under its
    ``cause``, record ``compile_ms``, and run the storm/steady-state
    bookkeeping.  Call sites time the first call under the new
    signature (a ``torch.export`` capture and its run for
    ``StaticFunction``, the eager step for the train steps) and classify
    the cause with :func:`classify_recompile` BEFORE recording the new
    signature."""
    if cause not in RECOMPILE_CAUSES:
        cause = "new_signature"
    s = _site(site)
    s.calls += 1
    s.compiles += 1
    s.causes[cause] = s.causes.get(cause, 0) + 1
    s.last_cause = cause
    s.compile_ms_total += float(compile_ms)
    monitor.stat_add("jit_compiles_total")
    monitor.stat_add(f"jit_compiles_{cause}_total")
    monitor.observe("compile_ms", float(compile_ms))
    warmup_calls = int(flag("health_compile_warmup_calls"))
    if s.calls > warmup_calls and s.compiles > 1:
        # a RE-compile past the warmup window: the signature cache was
        # supposed to be settled — count it, and K of them is a storm
        s.steady_recompiles += 1
        monitor.stat_add("jit_recompiles_steady_total")
        storm_k = int(flag("health_compile_storm_k"))
        if s.steady_recompiles >= storm_k and \
                s.steady_recompiles % storm_k == 0:
            flight.record("health.compile_storm", severity="warn",
                          site=site,
                          post_warmup_compiles=s.steady_recompiles,
                          causes=dict(s.causes))


def compile_report() -> Dict[str, dict]:
    """Per-site compile bookkeeping (JSON-able): calls, compiles,
    steady-state recompiles, per-cause counts, total compile ms."""
    with _sites_lock:
        sites = list(_sites.values())
    return {s.name: {"calls": s.calls, "compiles": s.compiles,
                     "steady_recompiles": s.steady_recompiles,
                     "causes": dict(s.causes),
                     "last_cause": s.last_cause,
                     "compile_ms_total": round(s.compile_ms_total, 3)}
            for s in sites}


class _TimedCompile:
    """Context manager the steps wrap a first call under a new signature
    in: a ``jit.compile`` tracer span carrying site + cause, timed into
    :func:`note_compile` on exit."""

    __slots__ = ("site", "cause", "_t0", "_span")

    def __init__(self, site: str, cause: str):
        self.site = site
        self.cause = cause
        self._span = None
        self._t0 = 0.0

    def __enter__(self):
        self._span = tracer.start_span(
            "jit.compile", attrs={"site": self.site, "cause": self.cause})
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        ms = (time.perf_counter() - self._t0) * 1e3
        self._span.__exit__(exc_type, exc, tb)
        if exc_type is None:
            note_compile(self.site, self.cause, ms)
        return False


def timed_compile(site: str, cause: Optional[str]):
    """See :class:`_TimedCompile` — the one-liner the steps use.
    ``cause=None`` (a cache hit) returns a no-op context, so a call
    site wraps its dispatch unconditionally instead of duplicating the
    dispatch expression across a compile/hit branch pair."""
    if cause is None:
        return contextlib.nullcontext()
    return _TimedCompile(site, cause)


# ---------------------------------------------------------------------------
# device-memory observability
# ---------------------------------------------------------------------------

def _live_storage_bytes() -> int:
    """The bytes of the distinct storages of the live CPU tensors the
    garbage collector tracks."""
    import gc
    seen, total = set(), 0
    for obj in gc.get_objects():
        if not issubclass(type(obj), torch.Tensor) \
                or obj.device.type != "cpu":
            continue
        try:
            st = obj.untyped_storage()
            key = st.data_ptr()
        except (RuntimeError, NotImplementedError):
            continue               # sparse, or an export's fake tensor
        if key and key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class MemoryTracker:
    """Live / peak device-byte gauges with per-tag attribution.

    :meth:`sample` reads the live bytes (the CUDA caching allocator's
    ``memory_allocated`` on the current card where CUDA is in use, else
    the distinct storages of the live CPU tensors) into
    ``device_mem_live_bytes`` and the high watermark into
    ``device_mem_peak_bytes``; a peak that grew by at least
    ``watermark_frac`` since the last watermark event records a
    ``health.mem_watermark`` flight event (the first nonzero peak counts).
    ``tags`` (``{"params": nbytes, "opt_state": nbytes}``) become
    ``device_mem_<tag>_bytes`` gauges.  :meth:`profile` writes the
    allocator's snapshot.
    """

    def __init__(self, watermark_frac: float = 0.25, clock=None):
        self.watermark_frac = float(watermark_frac)
        self.clock = clock or time.time
        self.live_bytes = 0
        self.peak_bytes = 0
        self.samples = 0
        self.tags: Dict[str, int] = {}
        self._watermark = 0
        self._lock = threading.Lock()

    def sample(self, tags: Optional[Dict[str, int]] = None) -> dict:
        """One measurement; returns ``{"live_bytes", "peak_bytes",
        "tags"}``.  Allocator counters on the card, no device sync."""
        if _cuda_in_use():
            live = int(torch.cuda.memory_allocated())
            peak_seen = int(torch.cuda.max_memory_allocated())
        else:
            live = peak_seen = _live_storage_bytes()
        with self._lock:
            self.samples += 1
            self.live_bytes = live
            self.peak_bytes = max(self.peak_bytes, live, peak_seen)
            new_watermark = self.peak_bytes > 0 and (
                self._watermark == 0 or self.peak_bytes >=
                self._watermark * (1.0 + self.watermark_frac))
            prev = self._watermark
            if new_watermark:
                self._watermark = self.peak_bytes
            if tags:
                self.tags.update({t: int(b) for t, b in tags.items()})
            tag_snapshot = dict(self.tags)
        monitor.stat_set("device_mem_live_bytes", live)
        monitor.stat_set("device_mem_peak_bytes", self.peak_bytes)
        for t, b in (tags or {}).items():
            monitor.stat_set(f"device_mem_{t}_bytes", int(b))
        if new_watermark:
            flight.record("health.mem_watermark", severity="info",
                          peak_bytes=self.peak_bytes, prev_watermark=prev,
                          tags=tag_snapshot, ts=self.clock())
        return {"live_bytes": live, "peak_bytes": self.peak_bytes,
                "tags": tag_snapshot}

    def track(self, tag: str, nbytes: int):
        """Attribute ``nbytes`` to ``tag`` without a full sample."""
        with self._lock:
            self.tags[tag] = int(nbytes)
        monitor.stat_set(f"device_mem_{tag}_bytes", int(nbytes))

    def profile(self, path: str) -> Optional[str]:
        """Pickle the CUDA caching allocator's snapshot
        (``torch.cuda.memory._snapshot()``, readable by PyTorch's memory
        visualiser) to ``path``; None where CUDA is not in use."""
        if not _cuda_in_use():
            return None
        import pickle
        with open(path, "wb") as f:
            pickle.dump(torch.cuda.memory._snapshot(), f)
        return path

    def snapshot(self) -> dict:
        with self._lock:
            return {"live_bytes": self.live_bytes,
                    "peak_bytes": self.peak_bytes,
                    "samples": self.samples, "tags": dict(self.tags)}

    def reset(self):
        with self._lock:
            self.live_bytes = 0
            self.peak_bytes = 0
            self.samples = 0
            self.tags.clear()
            self._watermark = 0


#: process-wide device-memory tracker (TrainStep / ingest hooks feed it)
memory = MemoryTracker()

_mem_calls = 0
_mem_lock = threading.Lock()


def maybe_sample_memory(tags_fn=None) -> Optional[dict]:
    """The TrainStep hook: sample device memory every
    ``FLAGS_health_mem_sample_every`` calls (0 = off — the default, so
    the per-step cost is one flag read).  ``tags_fn`` is invoked only
    when a sample actually runs."""
    every = int(flag("health_mem_sample_every"))
    if every <= 0:
        return None
    global _mem_calls
    with _mem_lock:
        _mem_calls += 1
        due = _mem_calls % every == 0
    if not due:
        return None
    return memory.sample(tags=tags_fn() if tags_fn is not None else None)
