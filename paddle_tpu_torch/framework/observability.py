"""Observability plane (port of paddle_tpu/framework/observability.py):
distributed tracing, the flight recorder, the metrics export.

* **Tracer**: trace and span ids over the profiler's host ranges.  A
  :class:`Span` covers one operation; its context (trace id, span id)
  can travel in a header (:meth:`Tracer.inject` / :meth:`Tracer.extract`)
  and causal links tie a consumer to the work it waited for.  Each
  process appends finished spans to ``trace_<label>.jsonl`` under
  ``FLAGS_trace_dir`` in the reference's JSON format, so the reference's
  ``span_summary`` and ``tools/trace_merge.py`` read a port trace as
  they read their own.  The steps open ``train.step`` (``jit``,
  ``distributed/ps``), ``zero.*`` (``parallel/zero.py``) and
  ``ps.prefetch`` spans.

* **FlightRecorder**: a bounded, thread-safe ring of structured events
  ``{ts, severity, kind, attrs}`` (chaos trips, retries, memory
  watermarks, loss-scale collapses), with the incident-storm guard.
  :func:`install_crash_handler` dumps it on an uncaught exception or
  SIGTERM, after the :func:`on_sigterm` callbacks.

* **Metrics export**: :class:`MetricsReporter` writes
  ``monitor.export_prometheus()`` to a file on an interval, atomically
  (tmp + fsync + rename); :func:`validate_prometheus` checks a rendering
  against the exposition grammar; with ``collector=`` it also pushes to
  the cluster collector (``framework/collector.py``).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.framework import locks, monitor
from paddle_tpu_torch.framework.flags import flag


def _atomic_write(path: str, data: str):
    """Write ``data`` to ``path`` so a reader sees the old file or the
    whole new one: a temporary file beside it, fsync, then rename.  The
    reference goes through ``fleet.utils.fs.LocalFS.atomic_write``, which
    ROADMAP item 5 ports."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


__all__ = ["SpanContext", "Span", "Tracer", "tracer", "FlightRecorder",
           "flight", "MetricsReporter", "install_crash_handler",
           "on_sigterm", "remove_sigterm_callback",
           "validate_prometheus", "span_summary"]


def _new_id() -> str:
    return os.urandom(8).hex()


class SpanContext:
    """What travels across a process boundary: (trace id, span id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"


class Span:
    """One traced operation.  Context-manager use nests it under the
    thread's current span and ends it on exit; ``detached=True`` spans
    (cross-thread work: a prefetch in flight, a server-side handler)
    are ended explicitly via :meth:`end` and never touch the creating
    thread's stack.

    While profiling is on, entering a span also enters a
    ``profiler.RecordEvent`` of the same name, so traced operations
    appear in the Profiling Report without double instrumentation."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "links", "_t0_wall", "_t0_perf", "_ended",
                 "_rec", "status")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 attrs: Optional[dict] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.links: List[dict] = []
        self._t0_wall = time.time()
        self._t0_perf = time.perf_counter()
        self._ended = False
        self._rec = None
        self.status = "ok"

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value):
        self.attrs[key] = value

    def link(self, span_id: Optional[str], kind: str = "link"):
        """Record a CAUSAL edge: the work of span ``span_id`` (produced
        on another thread/process — a prefetch task, an ingest fetch, a
        deferred push) was consumed by THIS span.  Parent/child edges
        say "ran inside"; links say "waited for".  ``tools/trace_merge``
        renders links as chrome-trace flow events and
        ``framework/blame.py`` walks them to rebuild the per-step
        dependency DAG.  ``None`` span ids (tracing off at the producer)
        are ignored."""
        if span_id is None:
            return
        self.links.append({"span": str(span_id), "kind": str(kind)})

    def __enter__(self):
        self.tracer._push(self.context())
        from paddle_tpu_torch import profiler
        if profiler.is_profiling():
            self._rec = profiler.RecordEvent(self.name)
            self._rec.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._rec is not None:
            self._rec.__exit__(exc_type, exc, tb)
            self._rec = None
        self.tracer._pop()
        self.end(status="error" if exc_type is not None else self.status,
                 **({"exc": repr(exc)} if exc is not None else {}))
        return False

    def end(self, status: str = "ok", **attrs):
        """Finish the span (idempotent) and append its record to the
        tracer's JSONL file."""
        if self._ended:
            return
        self._ended = True
        self.status = status
        if attrs:
            self.attrs.update(attrs)
        self.tracer._write_span(self)


class _NullSpan:
    """Returned by a disabled tracer: every operation is a no-op and the
    ids are None, so call sites can skip header injection cheaply."""

    trace_id = span_id = parent_id = None
    attrs: dict = {}
    links: tuple = ()
    status = "ok"

    def context(self):
        return None

    def set_attr(self, key, value):
        pass

    def link(self, span_id, kind: str = "link"):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, status: str = "ok", **attrs):
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Issues trace/span ids and appends finished spans to a JSONL file.

    One module-level singleton (:data:`tracer`) serves normal use —
    enabled via ``FLAGS_trace_dir`` (or :meth:`enable`), labeled via
    ``PADDLE_TRACE_LABEL`` (the launcher sets it per child).  Separate
    instances may be constructed for in-process multi-role tests (one
    file per logical "process") and handed to ``PsServer``/``PsClient``.

    Span file format — one JSON object per line:

    * ``{"kind": "process", "label", "pid", "clock_offset"}`` — emitted
      on open and again whenever :meth:`set_clock_offset` runs;
      ``clock_offset`` (seconds) is what ``trace_merge`` ADDS to this
      file's timestamps to land them on the reference clock.
    * ``{"kind": "span", "name", "trace", "span", "parent", "ts",
      "dur", "status", "tid", "attrs"}`` — ``ts`` epoch microseconds,
      ``dur`` microseconds; spans with causal links additionally carry
      ``"links": [{"span": <producer span id>, "kind": <edge kind>}]``
      (see :meth:`Span.link` / :meth:`link_next` — rendered as
      chrome-trace flow events by ``tools/trace_merge.py`` and walked
      by ``framework/blame.py``).

    ``FLAGS_trace_max_mb`` > 0 bounds segment growth: a full segment
    rotates to ``<path>.1`` (one kept) and a fresh one opens — see
    :meth:`_rotate_locked`.
    """

    def __init__(self, trace_dir: Optional[str] = None,
                 label: Optional[str] = None):
        self._dir = trace_dir
        self.label = label or os.environ.get(
            "PADDLE_TRACE_LABEL") or f"pid{os.getpid()}"
        self._file = None
        self._file_lock = locks.lock("obs.tracer.file")
        self._local = threading.local()
        self._checked_env = trace_dir is not None
        self.clock_offset = 0.0
        self.spans_written = 0
        # -- segment rotation (FLAGS_trace_max_mb): bound span-file
        # growth.  When the current segment exceeds the cap it is
        # renamed to <path>.1 (overwriting — at most TWO segments ever
        # exist, so a week-long traced run costs 2x the cap, not the
        # disk) and a fresh segment opens with a re-emitted process
        # meta record.  Rotations and the spans lost with an
        # overwritten .1 segment are counted (trace_rotations_total /
        # trace_spans_dropped_total)
        self.rotations = 0
        self.spans_dropped = 0
        self._segment_spans = 0      # spans in the current segment
        self._rotated_spans = 0      # spans sitting in the .1 segment

    # -- enablement ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        if not self._checked_env:
            # lazy env arming, chaos-style: a launcher can turn tracing
            # on for a whole child tree via FLAGS_trace_dir alone
            self._checked_env = True
            d = flag("trace_dir")
            if d:
                self._dir = str(d)
        return bool(self._dir)

    def enable(self, trace_dir: str, label: Optional[str] = None):
        with self._file_lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            self._dir = trace_dir
            self._checked_env = True
            if label:
                self.label = label
            # fresh target: the per-segment rotation accounting belongs
            # to the previous dir/label — carrying it over would charge
            # phantom drops against the new trace's first rotation
            self._segment_spans = 0
            self._rotated_spans = 0
        return self

    def disable(self):
        with self._file_lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            self._dir = None
            self._checked_env = True
            self._segment_spans = 0
            self._rotated_spans = 0

    def path(self) -> Optional[str]:
        """The span file this tracer appends to (None when disabled)."""
        if not self.enabled:
            return None
        return os.path.join(self._dir, f"trace_{self.label}.jsonl")

    # -- thread-local context stack -----------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, ctx: SpanContext):
        self._stack().append(ctx)

    def _pop(self):
        st = self._stack()
        if st:
            st.pop()

    def current(self) -> Optional[SpanContext]:
        st = self._stack()
        return st[-1] if st else None

    def activate(self, ctx: Optional[SpanContext]):
        """Adopt a foreign span context on THIS thread (background
        executors: the prefetch task runs under the span opened at
        issue time, so its RPCs parent correctly).  ``None`` is a
        no-op."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            if ctx is None:
                yield
                return
            self._push(ctx)
            try:
                yield
            finally:
                self._pop()
        return cm()

    # -- causal links across async boundaries -------------------------------
    _PENDING_CAP = 16

    def link_next(self, span_id: Optional[str], kind: str):
        """Declare that the NEXT consuming span started on this thread
        causally depends on producer span ``span_id`` — the hand-off
        idiom for code that releases work to a consumer it cannot see
        (the ingest pipeline yielding a prefetched batch to whatever
        train step runs next; code that hands work across an executor
        it does not own passes ``links=`` explicitly instead — see
        ``PsClient._rpc``).  Pending declarations attach to the next
        :meth:`start_span` on this thread whose ``consume_links`` is
        true (detached producer spans and the pipeline's own internal
        spans skip them); the list is bounded — a consumer that never
        opens a span cannot leak links without bound."""
        if span_id is None or not self.enabled:
            return
        pending = getattr(self._local, "pending", None)
        if pending is None:
            pending = self._local.pending = []
        pending.append({"span": str(span_id), "kind": str(kind)})
        del pending[:-self._PENDING_CAP]

    def _take_pending_links(self) -> List[dict]:
        pending = getattr(self._local, "pending", None)
        if not pending:
            return []
        out, pending[:] = list(pending), []
        return out

    # -- span creation ------------------------------------------------------
    def start_span(self, name: str, parent=None, attrs: Optional[dict] = None,
                   detached: bool = False,
                   consume_links: bool = True) -> Span:
        """New span under ``parent`` (a Span, SpanContext, or None for
        the thread's current span; a fresh trace when there is none).
        Context-manager use ends it automatically; ``detached=True``
        spans are ended explicitly with :meth:`Span.end`.  A
        non-detached span with ``consume_links`` (the default) adopts
        this thread's pending :meth:`link_next` declarations as causal
        links; producers pass ``consume_links=False`` so a hand-off
        waiting for its consumer is not swallowed by infrastructure
        spans."""
        if not self.enabled:
            return _NULL_SPAN
        if isinstance(parent, Span):
            parent = parent.context()
        if parent is None:
            parent = self.current()
        if parent is None:
            trace_id, parent_id = _new_id(), None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(self, name, trace_id, _new_id(), parent_id, attrs)
        if not detached and consume_links:
            span.links.extend(self._take_pending_links())
        return span

    # -- wire propagation ---------------------------------------------------
    def inject(self, header: dict, span: Optional[Span] = None) -> dict:
        """Stamp ``header`` with the span's (or current) context."""
        ctx = span.context() if isinstance(span, Span) else self.current()
        if ctx is not None:
            header["trace"] = ctx.trace_id
            header["span"] = ctx.span_id
        return header

    @staticmethod
    def extract(header: dict) -> Optional[SpanContext]:
        t, s = header.get("trace"), header.get("span")
        if t is None or s is None:
            return None
        return SpanContext(str(t), str(s))

    # -- clock correction ---------------------------------------------------
    def set_clock_offset(self, offset: float):
        """Record the measured offset to the reference clock (seconds to
        ADD to this process's timestamps); re-emits the process meta
        record so the merge uses the freshest measurement."""
        self.clock_offset = float(offset)
        if self.enabled:
            self._write(self._meta_record())

    # -- file plumbing ------------------------------------------------------
    def _meta_record(self) -> dict:
        return {"kind": "process", "label": self.label, "pid": os.getpid(),
                "clock_offset": self.clock_offset}

    def _write(self, record: dict):
        with self._file_lock:
            if self._dir is None:
                # disabled (possibly since the span started): a detached
                # span draining after shutdown drops its record instead
                # of crashing the training/serving path
                return
            if self._file is None:
                os.makedirs(self._dir, exist_ok=True)
                fresh = not os.path.exists(self.path())
                self._file = open(self.path(), "a")
                if fresh or os.path.getsize(self.path()) == 0:
                    self._file.write(json.dumps(self._meta_record()) + "\n")
            self._file.write(json.dumps(record, default=str) + "\n")
            self._file.flush()
            if record.get("kind") == "span":
                self._segment_spans += 1
            max_mb = float(flag("trace_max_mb"))
            if max_mb > 0 and self._file.tell() > max_mb * (1 << 20):
                self._rotate_locked()

    def _rotate_locked(self):
        """Roll the full current segment aside as ``<path>.1`` (one
        previous segment is kept; an older one is overwritten and its
        spans counted dropped) and open a fresh segment on the next
        write.  Called under ``_file_lock``."""
        self._file.close()
        self._file = None
        path = self.path()
        dropped = self._rotated_spans
        try:
            os.replace(path, path + ".1")
        except OSError:
            return                  # rotation is best-effort: keep tracing
        self._rotated_spans = self._segment_spans
        self._segment_spans = 0
        self.rotations += 1
        monitor.stat_add("trace_rotations_total")
        if dropped:
            self.spans_dropped += dropped
            monitor.stat_add("trace_spans_dropped_total", dropped)

    def _write_span(self, span: Span):
        dur = time.perf_counter() - span._t0_perf
        rec = {
            "kind": "span", "name": span.name, "trace": span.trace_id,
            "span": span.span_id, "parent": span.parent_id,
            "ts": span._t0_wall * 1e6, "dur": dur * 1e6,
            "status": span.status, "tid": threading.get_ident(),
            "attrs": span.attrs}
        if span.links:
            rec["links"] = list(span.links)
        self._write(rec)
        self.spans_written += 1


#: process-wide default tracer (FLAGS_trace_dir / PADDLE_TRACE_LABEL)
tracer = Tracer()


def span_summary(trace_dir: str, label: Optional[str] = None) -> List[dict]:
    """Per-span-name aggregates over every ``trace_*.jsonl`` file under
    ``trace_dir`` — count, total/mean/p99/max ms, error count — sorted
    heaviest-first.  ``label=`` restricts the summary to ONE process's
    span file (``trace_<label>.jsonl``) — the single-process view of a
    shared trace dir (the cluster collector's push path keeps its own
    incremental reader, ``collector._own_span_rows``, for the same
    file).  This reads the Tracer's OWN span-file format (the
    module that writes it owns the reader), so in-framework consumers
    (the run ledger's RunRecord capture) need no dependency on
    ``tools/trace_merge.py``; that tool renders the same shape from a
    merged chrome-trace.  Durations need no clock correction — offsets
    shift timestamps, not spans' lengths.  Malformed lines are skipped,
    torn-trace tolerant."""
    import glob

    durs: Dict[str, List[float]] = {}
    errors: Dict[str, int] = {}
    categories: Dict[str, str] = {}
    pattern = "trace_*.jsonl" if label is None else f"trace_{label}.jsonl"
    seg_paths = []
    for path in sorted(glob.glob(os.path.join(trace_dir, pattern))):
        # a rotated previous segment is the same logical trace
        seg_paths += [path + ".1", path]
    for path in seg_paths:
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") != "span":
                continue
            name = str(rec.get("name", "?"))
            durs.setdefault(name, []).append(
                float(rec.get("dur", 0.0)) / 1e3)
            if rec.get("status") == "error":
                errors[name] = errors.get(name, 0) + 1
            cat = (rec.get("attrs") or {}).get("category")
            if cat is not None and name not in categories:
                categories[name] = str(cat)
    rows = []
    for name, ms in durs.items():
        ms.sort()
        n = len(ms)
        # single-sample group: the p99 IS that sample (the general
        # nearest-rank formula agrees, but the contract is explicit —
        # blame tooling consumes these rows)
        p99 = ms[0] if n == 1 else \
            ms[min(n - 1, max(0, int(0.99 * n + 0.5) - 1))]
        row = {"name": name, "count": n,
               "total_ms": round(sum(ms), 3),
               "mean_ms": round(sum(ms) / n, 3),
               "p99_ms": round(p99, 3),
               "max_ms": round(ms[-1], 3),
               "errors": errors.get(name, 0)}
        if name in categories:
            row["category"] = categories[name]
        rows.append(row)
    rows.sort(key=lambda r: r["total_ms"], reverse=True)
    return rows


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

_SEVERITIES = ("debug", "info", "warn", "error")


class FlightRecorder:
    """Bounded ring of structured events — what the process was doing
    right before it mattered.  Thread-safe; recording is two dict
    allocations and a deque append, cheap enough for hot-ish paths
    (retries, fault trips), and the bound (``FLAGS_flight_capacity``)
    makes a week-long run's recorder the same size as a minute-long
    one's."""

    def __init__(self, capacity: Optional[int] = None):
        self._capacity = capacity
        self._ring = None                     # lazy: flag read at first use
        # reentrant: the SIGTERM crash handler dumps the recorder from
        # a signal frame that may interrupt the main thread mid-record
        # — a plain Lock would self-deadlock exactly when the launcher
        # kills a hung child (the PTA405 rule exists because of this
        # line; the tracked rlock keeps it visible to the watchdog)
        self._lock = locks.rlock("obs.flight")
        self.dropped = 0
        # per-kind lifetime totals (NOT ring-bounded): the run ledger's
        # "flight events by kind" capture must survive ring eviction
        self._kind_totals: Dict[str, int] = {}
        # per-process monotonic event id: multi-process flight dumps
        # merge in a stable order under clock skew (within one process
        # seq order IS record order, whatever the wall clock says).
        # Monotonic for the recorder's lifetime — clear() resets the
        # ring, not the sequence, so a post-clear event still sorts
        # after everything the collector already merged
        self._seq = 0
        # incident-storm guard: per-(kind, attrs) [window_start, count]
        # — a flapping signal repeating one identical event cannot wash
        # the bounded ring of the root cause recorded before it
        self._storm: Dict[tuple, list] = {}
        self.suppressed = 0
        # event listeners (framework/incident.py subscribes): called
        # OUTSIDE the ring lock with the live ev dict — a listener may
        # stamp attrs in place (the incident-id round-trip) but must
        # never raise into record()
        self._listeners: List = []

    def _buf(self) -> "collections.deque":
        if self._ring is None:
            cap = int(flag("flight_capacity")) if self._capacity is None \
                else int(self._capacity)
            self._ring = collections.deque(maxlen=max(1, cap))
        return self._ring

    def record(self, kind: str, severity: str = "info", **attrs):
        if severity not in _SEVERITIES:
            severity = "info"
        ev = {"ts": time.time(), "severity": severity, "kind": kind,
              "attrs": attrs}
        with self._lock:
            # lifetime kind totals count EVERY event, suppressed or
            # not — the run ledger's event mix stays truthful even
            # when the storm guard keeps the ring readable
            self._kind_totals[kind] = self._kind_totals.get(kind, 0) + 1
            if self._storm_suppress_locked(kind, attrs, ev["ts"]):
                self.suppressed += 1
                monitor.stat_add("flight_suppressed_total")
                ev["suppressed"] = True
                return ev
            buf = self._buf()
            if len(buf) == buf.maxlen:
                self.dropped += 1
            self._seq += 1
            ev["seq"] = self._seq
            buf.append(ev)
        # listeners run outside the lock (a listener that records its
        # own events — incident capture does — must not re-enter it
        # holding the ring) and get the LIVE dict: attrs they stamp
        # propagate to recent()/since() readers.  A listener fault is
        # swallowed — record() never fails its caller.
        for fn in list(self._listeners):
            try:
                fn(ev)
            except Exception:      # noqa: BLE001 — listener never breaks record
                pass
        return ev

    def add_listener(self, fn):
        """Subscribe ``fn(ev)`` to every non-suppressed recorded event
        (called outside the ring lock with the live event dict — attrs
        stamped in place round-trip through recent()/since()).
        Exceptions from ``fn`` are swallowed.  Returns ``fn``."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)
        return fn

    def remove_listener(self, fn) -> bool:
        """Unsubscribe a listener; True when it was registered."""
        with self._lock:
            try:
                self._listeners.remove(fn)
                return True
            except ValueError:
                return False

    def _storm_suppress_locked(self, kind: str, attrs: dict,
                               now: float) -> bool:
        """Incident-storm dedup (lock held): once ``flight_storm_k``
        IDENTICAL ``(kind, attrs)`` events landed within
        ``flight_storm_window`` seconds, further identical ones are
        suppressed (ring skipped; ``flight_suppressed_total`` and the
        lifetime kind totals still count them) until the window rolls.
        Events differing in ANY attr (a retry's attempt number, a
        chaos trip's call count) never dedup — only a truly flapping
        signal is rate-limited."""
        try:
            window = float(flag("flight_storm_window"))
            k = int(flag("flight_storm_k"))
        except KeyError:           # flags not registered yet (early
            return False           # import order) — guard off
        if window <= 0 or k <= 0:
            return False
        try:
            key = (kind, tuple(sorted(
                (a, repr(v)) for a, v in attrs.items())))
        except Exception:          # noqa: BLE001 — unorderable attrs:
            return False           # never let the guard break record()
        st = self._storm.get(key)
        if st is None or now - st[0] > window:
            if len(self._storm) >= 512:
                # bound the guard's own memory: drop entries whose
                # window already rolled (cheap sweep, rare)
                self._storm = {kk: vv for kk, vv in self._storm.items()
                               if now - vv[0] <= window}
            self._storm[key] = [now, 1]
            return False
        st[1] += 1
        return st[1] > k

    def last_seq(self) -> int:
        """The newest event's per-process seq id (0 = nothing recorded)
        — what a telemetry pusher remembers to ship only the delta."""
        with self._lock:
            return self._seq

    def since(self, seq: int, limit: int = 256) -> List[dict]:
        """Events with ``seq`` strictly greater than the given one,
        oldest first, capped at ``limit`` (a pusher that fell far behind
        ships the newest window rather than an unbounded backlog).
        Events already evicted from the ring are simply gone — the
        lifetime ``kind_totals`` still count them."""
        with self._lock:
            buf = [ev for ev in self._buf() if ev.get("seq", 0) > seq]
        return buf[-int(limit):]

    def kind_totals(self) -> Dict[str, int]:
        """Lifetime event counts by kind (unbounded, unlike the ring) —
        what ``monitor.snapshot()`` exposes as ``flight_events`` so a
        RunRecord captures the whole run's event mix in one call."""
        with self._lock:
            return dict(self._kind_totals)

    def recent(self, n: int = 50, kind: Optional[str] = None,
               min_severity: Optional[str] = None) -> List[dict]:
        """The most recent ``n`` events, oldest first.  ``kind`` keeps
        only events of that kind; ``min_severity`` drops events below
        the floor (severity order: debug < info < warn < error) — so a
        post-mortem query like ``recent(20, min_severity="warn")``
        skips the routine chatter."""
        with self._lock:
            buf = list(self._buf())
        if kind is not None:
            buf = [ev for ev in buf if ev["kind"] == kind]
        if min_severity is not None:
            if min_severity not in _SEVERITIES:
                raise ValueError(
                    f"unknown severity {min_severity!r} — one of "
                    f"{_SEVERITIES}")
            floor = _SEVERITIES.index(min_severity)
            buf = [ev for ev in buf
                   if _SEVERITIES.index(ev["severity"]) >= floor]
        n = int(n)
        return buf[-n:] if n > 0 else []

    def clear(self):
        with self._lock:
            self._buf().clear()
            self.dropped = 0
            self._kind_totals.clear()
            self._storm.clear()
            self.suppressed = 0

    def dump(self, path: str, worker: Optional[str] = None) -> str:
        """Write the ring to ``path`` as JSON, atomically (tmp+rename
        via the fs tier's crash-safe helper) — the post-mortem artifact
        ``launch._supervise`` and the crash handler produce."""
        with self._lock:
            events = list(self._buf())
            dropped = self.dropped
        payload = {"worker": worker, "pid": os.getpid(),
                   "dumped_at": time.time(), "dropped": dropped,
                   "events": events}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _atomic_write(path, json.dumps(payload, default=str))
        return path


#: process-wide flight recorder (chaos trips, PS retries, NaN rollbacks,
#: elastic membership events all land here)
flight = FlightRecorder()


# ---------------------------------------------------------------------------
# SIGTERM emergency callbacks (the preemption grace-window contract)
# ---------------------------------------------------------------------------

#: ordered (name, fn, deadline) registry the crash handler's SIGTERM hook
#: drains BEFORE dumping the flight ring — the durable-state plane
#: registers its emergency checkpoint save here
_sigterm_callbacks: List[tuple] = []
# reentrant: the SIGTERM hook drains the registry from signal-handler
# context — a plain Lock self-deadlocks if the interrupted thread was
# inside on_sigterm/remove_sigterm_callback when the signal landed
_sigterm_lock = locks.rlock("obs.sigterm")


def on_sigterm(name: str, fn, deadline: Optional[float] = None):
    """Register a deadline-bounded emergency callback for SIGTERM.

    When the :func:`install_crash_handler` SIGTERM hook fires, every
    registered callback runs (registration order) on a helper thread
    joined with its deadline (``FLAGS_ckpt_emergency_deadline`` when
    None) — a hung save cannot eat the platform's grace window; the
    flight dump and the chained/re-delivered signal still happen.  Each
    run is recorded (``sigterm.callback`` flight event: ok / error /
    timeout).  Re-registering a name replaces the previous callback
    (the training loop re-arms each generation with fresh state)."""
    with _sigterm_lock:
        _sigterm_callbacks[:] = [c for c in _sigterm_callbacks
                                 if c[0] != name]
        _sigterm_callbacks.append((name, fn, deadline))
    return fn


def remove_sigterm_callback(name: str) -> bool:
    """Drop a registered emergency callback; True when it existed."""
    with _sigterm_lock:
        n = len(_sigterm_callbacks)
        _sigterm_callbacks[:] = [c for c in _sigterm_callbacks
                                 if c[0] != name]
        return len(_sigterm_callbacks) < n


def _run_sigterm_callbacks():
    with _sigterm_lock:
        cbs = list(_sigterm_callbacks)
    for name, fn, deadline in cbs:
        if deadline is None:
            deadline = float(flag("ckpt_emergency_deadline"))
        box: Dict[str, Any] = {}

        def run(fn=fn, box=box):
            try:
                fn()
                box["status"] = "ok"
            except BaseException as e:  # noqa: BLE001 — post-mortem record
                box["status"] = "error"
                box["error"] = repr(e)

        t = threading.Thread(target=run, name=f"sigterm-{name}",
                             daemon=True)
        t0 = time.monotonic()
        t.start()
        t.join(deadline)
        status = box.get("status", "timeout")
        flight.record("sigterm.callback",
                      severity="info" if status == "ok" else "error",
                      name=name, status=status,
                      elapsed_s=round(time.monotonic() - t0, 3),
                      **({"error": box["error"]} if "error" in box else {}))
        monitor.stat_add(f"sigterm_callback_{status}_total")


def install_crash_handler(worker: Optional[str] = None,
                          flight_dir: Optional[str] = None,
                          chain: bool = True, sigterm: bool = True):
    """Hook ``sys.excepthook`` so an uncaught exception dumps the flight
    recorder to ``<flight_dir>/flight_<worker>.json`` before the normal
    traceback.  ``worker`` defaults to the elastic worker id the
    launcher exported (``PADDLE_ELASTIC_WORKER_ID``) or ``pid<n>``;
    ``flight_dir`` to ``FLAGS_flight_dir`` (cwd when empty).  Returns
    the installed hook (tests call it directly; ``chain=False``
    suppresses the chained traceback print).

    ``sigterm=True`` (default) additionally dumps on SIGTERM: a hung
    child the launcher/agent kills never reaches the excepthook, and a
    post-mortem with no flight file is exactly when one is needed.  The
    SIGTERM dump chains to the previously installed handler — or, under
    the default disposition, restores it and re-delivers the signal so
    the exit status still says SIGTERM.  Installing from a non-main
    thread skips the signal hook (the excepthook still installs)."""
    import sys
    worker_id = worker or os.environ.get("PADDLE_ELASTIC_WORKER_ID") \
        or f"pid{os.getpid()}"
    base = flight_dir if flight_dir is not None else \
        (str(flag("flight_dir")) or ".")
    prev = sys.excepthook

    def _dump(kind: str, **attrs):
        flight.record(kind, severity="error", worker=worker_id, **attrs)
        try:
            flight.dump(os.path.join(base, f"flight_{worker_id}.json"),
                        worker=worker_id)
        except OSError:
            pass                    # a full disk must not mask the crash

    def hook(exc_type, exc, tb):
        _dump("crash", exc=repr(exc))
        if chain:
            prev(exc_type, exc, tb)

    sys.excepthook = hook
    if sigterm:
        import signal as _signal
        prev_term = _signal.getsignal(_signal.SIGTERM)

        def term_hook(signum, frame):
            # emergency callbacks (deadline-bounded) run FIRST: the
            # whole point of the grace window is the state they save
            _run_sigterm_callbacks()
            _dump("sigterm")
            if callable(prev_term):
                prev_term(signum, frame)
            elif prev_term is _signal.SIG_IGN:
                # explicitly ignored before we installed: the dump must
                # not turn an ignored SIGTERM into process death
                return
            else:
                # default disposition (or a handler we cannot chain):
                # restore and re-deliver, so the process still dies
                # with the SIGTERM exit status the supervisor expects
                _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
                os.kill(os.getpid(), _signal.SIGTERM)

        try:
            _signal.signal(_signal.SIGTERM, term_hook)
        except ValueError:
            pass                    # non-main thread: no signal hook
    return hook


# ---------------------------------------------------------------------------
# metrics export plane
# ---------------------------------------------------------------------------

class MetricsReporter:
    """Background thread rendering ``monitor.export_prometheus()`` to
    ``path`` every ``interval`` seconds (``FLAGS_metrics_export_interval``
    default), atomically (tmp + fsync + rename): a scraper or a textfile
    collector never sees a torn file.  ``write_once()`` is the synchronous
    form (tests, final flush).

    Push mode (``collector=``, reference ``:903-914``): additionally (or,
    with ``path=None``, only) ship each interval's telemetry to the
    cluster collector (``framework/collector.py``): ``monitor.snapshot()``
    deltas, span summaries and flight-event deltas, stamped with a
    per-process push seq, fire and forget through a bounded queue (drop
    counter, ``collector.rpc`` chaos point).  ``collector`` is a
    ``host:port`` string or a ``collector.CollectorClient``; ``role`` /
    ``worker`` label the payloads (default the launcher's
    ``PADDLE_ROLE`` / ``PADDLE_TRACE_LABEL``)."""

    def __init__(self, path: Optional[str], interval: Optional[float] = None,
                 collector=None, worker: Optional[str] = None,
                 role: Optional[str] = None, payload_extra=None):
        if path is None and collector is None:
            raise ValueError("MetricsReporter needs a path, a collector "
                             "endpoint, or both")
        self.path = path
        self.interval = float(flag("metrics_export_interval")) \
            if interval is None else float(interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.writes = 0
        self.pushes = 0
        self._collector = None
        self._payload_extra = payload_extra
        if collector is not None:
            from paddle_tpu_torch.framework import collector as _coll
            self._collector = _coll.CollectorClient(
                collector, worker=worker, role=role) \
                if isinstance(collector, str) else collector

    @property
    def collector(self):
        """The push-mode CollectorClient (None in file-only mode)."""
        return self._collector

    def write_once(self) -> str:
        text = ""
        if self.path is not None:
            text = monitor.export_prometheus()
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            _atomic_write(self.path, text)
            # start()'s first write precedes the thread and stop()'s last
            # one follows the join: never concurrent with _loop
            self.writes += 1
        if self._collector is not None:
            from paddle_tpu_torch.framework import collector as _coll
            extra = None
            if self._payload_extra is not None:
                try:
                    extra = self._payload_extra()
                except Exception:  # noqa: BLE001 - telemetry never crashes
                    extra = None
            self._collector.push(_coll.local_payload(
                since_seq=self._collector.flight_seq_sent, extra=extra))
            self.pushes += 1
        return text

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.write_once()
            except OSError:
                pass                # transient fs trouble: keep reporting

    def start(self) -> "MetricsReporter":
        self.write_once()
        # a daemon: the reporter never blocks interpreter exit, and a kill
        # mid-write leaves the whole old file (tmp + rename)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="metrics-reporter")
        self._thread.start()
        return self

    def stop(self, final_write: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if final_write:
            try:
                self.write_once()
            except OSError:
                pass
        if self._collector is not None:
            self._collector.stop()


# ---------------------------------------------------------------------------
# prometheus text-format grammar check (the CI lane's gate)
# ---------------------------------------------------------------------------

import re as _re  # noqa: E402

_PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_PROM_COMMENT_RE = _re.compile(
    rf"^# (HELP {_PROM_NAME} .*|TYPE {_PROM_NAME} "
    r"(counter|gauge|histogram|summary|untyped))$")
_PROM_SAMPLE_RE = _re.compile(
    rf"^({_PROM_NAME})"
    r"(?:\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\""
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\")*\})?"
    r" [-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN)"
    r"(?: [0-9]+)?$")
_PROM_LE_RE = _re.compile(r'le="([^"]+)"')


def validate_prometheus(text: str, require_help: bool = False) -> int:
    """Validate ``text`` against the Prometheus exposition text-format
    grammar (comment/sample line shapes) plus histogram invariants:
    cumulative non-decreasing buckets, a ``+Inf`` bucket equal to
    ``_count``, and ``_sum``/``_count`` present for every histogram.
    A ``# HELP`` may appear at most once per metric and must precede
    that metric's samples; ``require_help=True`` additionally demands a
    HELP line for every ``# TYPE``-declared metric — the full contract
    a real Prometheus scraper expects of ``export_prometheus()``
    output.  Returns the number of sample lines; raises ``ValueError``
    on the first violation."""
    samples = 0
    hist_names: List[str] = []
    type_names: List[str] = []
    help_names: set = set()
    sampled_names: set = set()
    values: Dict[str, float] = {}
    buckets: Dict[str, List[tuple]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            if not _PROM_COMMENT_RE.match(line):
                raise ValueError(f"line {i}: malformed comment: {line!r}")
            if line.startswith("# TYPE "):
                type_names.append(line.split()[2])
                if line.endswith(" histogram"):
                    hist_names.append(line.split()[2])
            elif line.startswith("# HELP "):
                h = line.split()[2]
                if h in help_names:
                    raise ValueError(f"line {i}: duplicate HELP for {h}")
                if h in sampled_names:
                    raise ValueError(
                        f"line {i}: HELP for {h} after its samples")
                help_names.add(h)
            continue
        m = _PROM_SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample: {line!r}")
        samples += 1
        name = m.group(1)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[:-len(suffix)]
                break
        sampled_names.add(name)
        sampled_names.add(base)
        rest = line.split("} ", 1)[1] if "} " in line \
            else line.split(" ", 1)[1]
        val = float(rest.split(" ")[0])
        if name.endswith("_bucket"):
            le = _PROM_LE_RE.search(line)
            if le is None:
                raise ValueError(f"line {i}: bucket without le label")
            buckets.setdefault(name[:-len("_bucket")], []).append(
                (le.group(1), val))
        else:
            values[name] = val
    for h in hist_names:
        bks = buckets.get(h)
        if not bks:
            raise ValueError(f"histogram {h}: no buckets")
        nums = [float("inf") if le == "+Inf" else float(le)
                for le, _ in bks]
        counts = [c for _, c in bks]
        if nums != sorted(nums) or nums[-1] != float("inf"):
            raise ValueError(f"histogram {h}: buckets not ascending "
                             "or missing +Inf")
        if any(b > a for b, a in zip(counts, counts[1:])):
            raise ValueError(f"histogram {h}: buckets not cumulative")
        if h + "_count" not in values or h + "_sum" not in values:
            raise ValueError(f"histogram {h}: missing _sum/_count")
        if counts[-1] != values[h + "_count"]:
            raise ValueError(f"histogram {h}: +Inf bucket "
                             f"{counts[-1]} != _count {values[h + '_count']}")
    if require_help:
        missing = [n for n in type_names if n not in help_names]
        if missing:
            raise ValueError(
                f"metrics declared without a # HELP line: {missing[:5]}"
                + ("..." if len(missing) > 5 else ""))
    return samples
