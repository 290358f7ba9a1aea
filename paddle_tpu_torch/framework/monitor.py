"""Monitor counters (port of paddle_tpu/framework/monitor.py, itself
Paddle's StatRegistry, platform/monitor.h:77).

Process-wide named int/float counters and fixed-bucket histograms that
the train steps bump cheaply and loggers read: ``stat_add`` /
``stat_set`` / ``observe``, ``snapshot`` (the JSON form
``tools/health_check.py`` reads) and ``export_prometheus`` (the
exposition text, byte for byte the reference's for the same calls: a
metric nobody described gets the same generated ``# HELP`` text).
Thread-safe; no device is touched.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

__all__ = ["StatRegistry", "Histogram", "get_histogram", "observe",
           "all_histograms", "reset_all_histograms", "stat_add",
           "stat_sub", "stat_set", "get_stat", "reset_stat", "all_stats",
           "reset_all_stats", "describe", "export_prometheus",
           "snapshot"]

Number = Union[int, float]


class _Stat:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, value: Number = 0):
        self.name = name
        self.value = value
        self._lock = threading.Lock()

    def increase(self, v: Number = 1):
        with self._lock:
            self.value += v

    def decrease(self, v: Number = 1):
        with self._lock:
            self.value -= v

    def set(self, v: Number):
        with self._lock:
            self.value = v

    def reset(self):
        with self._lock:
            self.value = 0


class StatRegistry:
    """monitor.h:77 StatRegistry<T>, without the int/float template split —
    python numbers unify both instantiations."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._stats: Dict[str, _Stat] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "StatRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def get(self, name: str) -> _Stat:
        with self._lock:
            s = self._stats.get(name)
            if s is None:
                s = self._stats[name] = _Stat(name)
            return s

    def stats(self) -> Dict[str, Number]:
        with self._lock:
            return {n: s.value for n, s in self._stats.items()}

    def reset_all(self):
        with self._lock:
            for s in self._stats.values():
                s.reset()


class Histogram:
    """Fixed-bucket latency/size histogram (the role of brpc's bvar
    LatencyRecorder, reduced to what the PS transport counters need):
    exponential bucket bounds, exact count/sum/max, and interpolated
    percentiles good enough for p50/p95/p99 dashboards.  Thread-safe."""

    # ~exponential bounds; unit-agnostic (the PS transport records ms)
    BOUNDS = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
              200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0)

    def __init__(self, name: str = ""):
        self.name = name
        self._counts = [0] * (len(self.BOUNDS) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def record(self, value: Number):
        v = float(value)
        i = 0
        for b in self.BOUNDS:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v

    def reset(self):
        """Zero the histogram IN PLACE — live references (e.g. the
        per-op latency histograms TransportStats holds) keep recording
        into the same registered object."""
        with self._lock:
            self._counts = [0] * (len(self.BOUNDS) + 1)
            self.count = 0
            self.sum = 0.0
            self.max = 0.0

    def percentile(self, p: float) -> float:
        """Linearly interpolated p-quantile: position within the bucket
        holding the quantile, between the bucket's lower and upper
        bounds (0 with no data; ``max`` for the overflow bucket —
        honest about saturation)."""
        with self._lock:
            if not self.count:
                return 0.0
            target = p * self.count
            seen = 0
            for i, c in enumerate(self._counts):
                prev = seen
                seen += c
                if c and seen >= target:
                    if i >= len(self.BOUNDS):
                        return self.max
                    lo = self.BOUNDS[i - 1] if i > 0 else 0.0
                    hi = self.BOUNDS[i]
                    frac = min(1.0, max(0.0, (target - prev) / c))
                    return lo + frac * (hi - lo)
            return self.max

    def buckets(self):
        """Snapshot of (bounds, per-bucket counts incl. the overflow
        slot, total count, sum) — the cumulative-bucket renderer's
        input (export_prometheus)."""
        with self._lock:
            return (list(self.BOUNDS), list(self._counts),
                    self.count, self.sum)

    def summary(self) -> Dict[str, Number]:
        with self._lock:
            count, total, mx = self.count, self.sum, self.max
        return {"count": count, "sum": round(total, 3),
                "mean": round(total / count, 4) if count else 0.0,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99), "max": round(mx, 3)}


_hists: Dict[str, Histogram] = {}
_hist_lock = threading.Lock()


def get_histogram(name: str) -> Histogram:
    with _hist_lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram(name)
        return h


def observe(name: str, value: Number):
    """Record one observation into the named histogram (histogram
    sibling of :func:`stat_add`)."""
    get_histogram(name).record(value)


def all_histograms() -> Dict[str, Dict[str, Number]]:
    with _hist_lock:
        hs = list(_hists.values())
    return {h.name: h.summary() for h in hs}


def reset_all_histograms():
    """Zero every registered histogram IN PLACE.  Clearing the registry
    dict instead would orphan live references (TransportStats etc.):
    their subsequent records would vanish from :func:`all_histograms`."""
    with _hist_lock:
        hs = list(_hists.values())
    for h in hs:
        h.reset()


def stat_add(name: str, value: Number = 1):
    """STAT_ADD / STAT_INT_ADD / STAT_FLOAT_ADD (monitor.h:135,140)."""
    StatRegistry.instance().get(name).increase(value)


def stat_sub(name: str, value: Number = 1):
    StatRegistry.instance().get(name).decrease(value)


def stat_set(name: str, value: Number):
    """Overwrite the named stat (gauge semantics — e.g. the ingest
    plane's ``input_stall_pct``, recomputed per batch rather than
    accumulated)."""
    StatRegistry.instance().get(name).set(value)


def get_stat(name: str) -> Number:
    return StatRegistry.instance().get(name).value


def reset_stat(name: str):
    StatRegistry.instance().get(name).reset()


def all_stats() -> Dict[str, Number]:
    return StatRegistry.instance().stats()


def reset_all_stats():
    StatRegistry.instance().reset_all()


def snapshot(labels=None) -> Dict[str, dict]:
    """One JSON-able capture of the whole registry: every stat value
    plus every histogram's summary AND raw buckets — the metrics
    snapshot ``tools/health_check.py`` consumes (richer than the
    Prometheus rendering: percentiles come pre-interpolated and the
    bucket arrays survive round-tripping).

    ``labels=`` (an iterable of name prefixes) keeps only stats and
    histograms whose name starts with one of the prefixes — the run
    ledger's capture narrows a huge registry to the series it records
    without a second pass.  ``None`` and an EMPTY iterable both mean
    "no filter" (an empty prefix tuple would otherwise silently drop
    everything — a config that supplies no prefixes wants the default,
    not a blank snapshot).  The ``flight_events`` section (lifetime
    flight-recorder event counts by kind) always rides along, so one
    snapshot call is a complete RunRecord capture."""
    if isinstance(labels, str):
        labels = (labels,)         # a bare string must not filter by
    prefixes = tuple(str(p) for p in labels) if labels is not None \
        else ()                    # its individual characters
    if prefixes:
        def keep(name: str) -> bool:
            return name.startswith(prefixes)
    else:
        def keep(name: str) -> bool:
            return True
    with _hist_lock:
        hs = sorted(_hists.items())
    hists = {}
    for name, h in hs:
        if not keep(name):
            continue
        bounds, counts, count, total = h.buckets()
        rec = h.summary()
        rec["bounds"] = bounds
        rec["bucket_counts"] = counts
        hists[name] = rec
    # lazy: monitor is imported by observability
    from paddle_tpu_torch.framework.observability import flight
    flight_events = flight.kind_totals()
    return {"stats": {n: v for n, v in all_stats().items() if keep(n)},
            "histograms": hists, "flight_events": flight_events}


# ---------------------------------------------------------------------------
# metrics export (Prometheus exposition text format)
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    """Sanitize a stat/histogram name into the Prometheus metric-name
    charset ([a-zA-Z_:][a-zA-Z0-9_:]*)."""
    import re
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not n or not re.match(r"[a-zA-Z_:]", n[0]):
        n = "_" + n
    return n


def _prom_num(v: Number) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"                  # a NaN gauge (numerics on a bad
    if f in (float("inf"), float("-inf")):  # step) must still scrape
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _split_leaf(name: str):
    """Split a per-leaf stat name — ``base[leaf.path]`` (the numerics
    plane's attribution gauges carry dotted/bracketed pytree paths) —
    into ``(base, leaf)``; ``(name, None)`` for a plain stat."""
    if name.endswith("]") and "[" in name:
        base, leaf = name.split("[", 1)
        return base, leaf[:-1]
    return name, None


def _prom_label_value(v: str) -> str:
    """Escape a label value per the Prometheus exposition grammar
    (backslash, double quote, newline)."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


# metric help texts (# HELP lines): registered by the subsystems that
# own the metric, keyed by the RAW (pre-sanitization) name; metrics
# nobody described get a generated placeholder so a real Prometheus
# scraper (which expects HELP before TYPE) is always satisfied
_help: Dict[str, str] = {}
_help_lock = threading.Lock()


def describe(name: str, help_text: str):
    """Register the ``# HELP`` text for a metric (stat or histogram) —
    one line, no newlines; later registrations win."""
    with _help_lock:
        _help[name] = " ".join(str(help_text).split())


def _help_for(raw_name: str, sanitized: str) -> str:
    with _help_lock:
        text = _help.get(raw_name)
    if text is None:
        text = f"paddle_tpu metric {raw_name}"
    # HELP text escaping per the exposition format: backslash + newline
    return (f"# HELP {sanitized} "
            + text.replace("\\", "\\\\").replace("\n", "\\n"))


def export_prometheus() -> str:
    """Render every registered stat (as a gauge — ``stat_sub`` means
    values may go down) and every histogram (cumulative ``_bucket``
    series + ``_sum``/``_count``) in the Prometheus exposition text
    format, ready for a textfile collector or HTTP scrape handler.

    Every metric gets a ``# HELP`` line before its ``# TYPE`` (text
    from :func:`describe`, or a generated placeholder) — a real
    Prometheus scraper expects the pair.  Names are sanitized into the
    metric-name charset (dots and any other outsider become
    underscores); a per-leaf stat named ``base[leaf.path]`` exports as
    ``base{leaf="leaf.path"}`` — the pytree path survives verbatim in
    the (escaped) label value instead of being mangled into the metric
    name.  ``observability.validate_prometheus`` checks the grammar
    (pass ``require_help=True`` for the full scraper contract); the CI
    observability lane round-trips this output through it."""
    lines = []
    seen = set()
    groups: Dict[str, list] = {}
    raw_names: Dict[str, str] = {}
    for name, v in sorted(all_stats().items()):
        base, leaf = _split_leaf(name)
        n = _prom_name(base)
        raw_names.setdefault(n, base)
        label = None if leaf is None else \
            f'leaf="{_prom_label_value(leaf)}"'
        pairs = groups.setdefault(n, [])
        if any(lab == label for lab, _ in pairs):
            continue                      # sanitization collision: first wins
        pairs.append((label, v))
    for n in sorted(groups):
        seen.add(n)
        lines.append(_help_for(raw_names[n], n))
        lines.append(f"# TYPE {n} gauge")
        for label, v in groups[n]:
            lines.append(f"{n} {_prom_num(v)}" if label is None
                         else f"{n}{{{label}}} {_prom_num(v)}")
    with _hist_lock:
        hs = sorted(_hists.items())
    for name, h in hs:
        n = _prom_name(name)
        if n in seen:
            continue
        seen.add(n)
        bounds, counts, count, total = h.buckets()
        lines.append(_help_for(name, n))
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for b, c in zip(bounds, counts):
            cum += c
            lines.append(f'{n}_bucket{{le="{_prom_num(b)}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{n}_sum {_prom_num(total)}")
        lines.append(f"{n}_count {count}")
    return "\n".join(lines) + "\n"


# core train-loop metrics described where the registry lives; subsystem
# metrics are described by their owning modules via describe()
describe("train_step_ms", "per-step wall time (ms) histogram")
describe("train_steps_total", "train steps completed")
describe("input_stall_pct",
         "share of step time spent waiting on input (gauge)")
describe("collector_pushes_total",
         "telemetry payloads handed to the collector push queue")
describe("collector_dropped_total",
         "telemetry payloads dropped (queue full, dead collector, "
         "injected collector.rpc fault) — never blocks the pusher")
