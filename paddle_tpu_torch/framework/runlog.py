"""Persistent run ledger — the observatory's memory (port of
paddle_tpu/framework/runlog.py; ``run_meta`` names torch, CUDA and the
card where the reference names JAX).

Every process in this repo already measures itself (tracer spans,
``monitor.snapshot()``, flight events, health anomalies, bench legs) and
then throws the measurement away when it exits: ``BENCH_r*.json`` files
are disconnected snapshots nobody compares, and the GDP-style
auto-tuning loop on the ROADMAP is blocked on exactly the artifact that
never gets built — a queryable history of measured runs.  This module
closes measurement into memory:

* :class:`RunLedger` — a schema-versioned, append-only JSONL store
  (``<FLAGS_runlog_dir>/ledger.jsonl`` by convention).  Appends are
  crash-safe (fcntl lock + O_APPEND + fsync — true appends, so a
  growing history costs O(1) I/O per record, not a full rewrite) and
  independently-launched processes on one host share one ledger;
  readers skip a torn tail instead of crashing
  (``runlog_skipped_records_total``) and tolerate schema-version skew
  (an old reader sees a newer record's known fields and ignores the
  rest).  Ledger I/O faults must never crash the run being recorded:
  every append runs under the ``runlog.observe`` chaos point and
  degrades to a ``runlog.write_error`` flight event + counter.

* :func:`capture` — one call that assembles a :data:`RunRecord`-shaped
  dict from the planes that already exist: run metadata
  (:func:`run_meta` — git sha/dirty, host, FLAGS overrides, versions),
  ``monitor.snapshot()`` (stats + histograms + flight-event kind
  totals), a trace summary (per-span-name aggregates when a trace dir
  is given), and the scalar summary series ``tools/perf_report.py
  compare`` detects regressions over (step-time p99, RPC p99, input
  stall, compile counts, anomaly totals).

Producers in-tree: ``bench.py`` (every completed leg),
``tools/op_bench.py`` (``--ledger``), ``tools/health_check.py
--mini-train`` (``--ledger``), and ``TrainEpochRange`` (when
``FLAGS_runlog_dir`` is set).  ``tools/perf_report.py`` is the
consumer: ``attribute`` joins a merged trace with the PTA106 analytic
cost model, ``compare`` runs ``health.Detector`` over ledger series and
exits nonzero on named regressions.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.framework import chaos, locks, monitor
from paddle_tpu_torch.framework.flags import flag

__all__ = ["SCHEMA_VERSION", "LEDGER_NAME", "RunLedger", "run_meta",
           "capture", "default_ledger_path", "bench_record_to_legs",
           "import_bench_file"]

#: bump when the RunRecord shape changes incompatibly; readers must keep
#: accepting records stamped with a DIFFERENT version (known fields are
#: read, unknown fields ignored) — skew degrades, never crashes
SCHEMA_VERSION = 1

LEDGER_NAME = "ledger.jsonl"


def default_ledger_path() -> Optional[str]:
    """``<FLAGS_runlog_dir>/ledger.jsonl``, or None when the flag is
    empty (the implicit producers — TrainEpochRange — stay off)."""
    d = str(flag("runlog_dir") or "")
    if not d:
        return None
    return os.path.join(d, LEDGER_NAME)


# ---------------------------------------------------------------------------
# run metadata (the PR-7 bench metadata, shared)
# ---------------------------------------------------------------------------

_META: Optional[dict] = None
_META_LOCK = locks.lock("runlog.meta")


def run_meta(refresh: bool = False) -> dict:
    """Run metadata stamped into every record, so a regression the
    observatory flags is attributable to the change that caused it:
    git sha (+dirty), host, platform, active FLAGS overrides, versions,
    argv.  The static fields are computed once per process;
    ``flags_overrides`` is re-read every call (a flag flipped after the
    first capture must show in later records).  Every field
    best-effort — metadata must never fail the run it describes."""
    global _META
    with _META_LOCK:
        if _META is not None and not refresh:
            meta = dict(_META)
            try:
                from paddle_tpu_torch.framework import flags as _flags
                meta["flags_overrides"] = _flags.overrides()
            except Exception:      # noqa: BLE001
                pass
            return meta
    import platform
    import socket
    import subprocess
    import sys
    meta: Dict[str, Any] = {
        "host": socket.gethostname(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "argv": list(sys.argv[1:])}
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        meta["git_sha"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo, capture_output=True,
            text=True, timeout=10).stdout.strip() or None
    except Exception:              # noqa: BLE001 — no git, shallow, etc.
        meta["git_sha"] = None
    try:
        # independent of the sha: a slow/failed `git status` must not
        # clobber an already-computed sha
        meta["git_dirty"] = bool(subprocess.run(
            ["git", "status", "--porcelain"], cwd=repo,
            capture_output=True, text=True, timeout=10).stdout.strip())
    except Exception:              # noqa: BLE001
        meta["git_dirty"] = None
    try:
        import torch
        meta["torch"] = torch.__version__
        meta["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            meta["device"] = torch.cuda.get_device_name(0)
            meta["device_count"] = torch.cuda.device_count()
    except Exception:              # noqa: BLE001
        pass
    try:
        from paddle_tpu_torch.framework import flags as _flags
        meta["flags_overrides"] = _flags.overrides()
    except Exception:              # noqa: BLE001
        meta["flags_overrides"] = {}
    with _META_LOCK:
        _META = meta
    return dict(meta)


_RUN_ID: Optional[str] = None


def _run_id() -> str:
    """One id per process, so a multi-leg run's records group.  Minted
    under the meta lock: the id embeds a timestamp, so two racing first
    callers (a TrainEpochRange capture vs a collector capture thread)
    would otherwise mint DIFFERENT ids and split one run's records
    (PTA404)."""
    global _RUN_ID
    with _META_LOCK:
        if _RUN_ID is None:
            _RUN_ID = f"{os.getpid()}-" \
                      f"{int(time.time() * 1e3) & 0xffffffff:x}"
        return _RUN_ID


# ---------------------------------------------------------------------------
# record capture
# ---------------------------------------------------------------------------

def _summary_from_snapshot(snap: dict) -> dict:
    """The per-run scalar series compare detects over, pulled from a
    ``monitor.snapshot()``: histogram p99s for the latency signals,
    counter totals for the rest.  Missing signals are simply absent —
    a record never carries fabricated zeros for planes that were off."""
    stats = snap.get("stats", {})
    hists = snap.get("histograms", {})
    out: Dict[str, float] = {}
    h = hists.get("train_step_ms")
    if h and h.get("count"):
        out["train_step_p99_ms"] = float(h.get("p99", 0.0))
        out["train_step_mean_ms"] = float(h.get("mean", 0.0))
    # client RPC latency lives as per-op histograms
    # (ps_client_rpc_ms_<op>): fold them into one worst-op p99 and a
    # count-weighted mean — the cross-run latency series
    rpc = [h for n, h in hists.items()
           if n.startswith("ps_client_rpc_ms_") and h.get("count")]
    if rpc:
        total = sum(h["count"] for h in rpc)
        out["ps_rpc_p99_ms"] = float(max(h.get("p99", 0.0) for h in rpc))
        out["ps_rpc_mean_ms"] = float(
            sum(h.get("sum", 0.0) for h in rpc) / total) if total else 0.0
    for name in ("input_stall_pct", "jit_compiles_total",
                 "jit_recompiles_steady_total", "health_anomalies_total",
                 "numerics_nonfinite_steps_total", "train_steps_total",
                 "train_nan_skips_total",
                 "zero_collective_bytes_per_step"):
        if name in stats:
            out[name] = float(stats[name])
    return out


def capture(kind: str, label: Optional[str] = None,
            legs: Optional[List[dict]] = None,
            trace_dir: Optional[str] = None,
            labels=None, meta: Optional[dict] = None,
            include_snapshot: bool = True,
            extra: Optional[dict] = None,
            blame_result: Optional[dict] = None) -> dict:
    """Assemble one RunRecord dict (no I/O — pair with
    :meth:`RunLedger.append`).

    ``kind`` names the producer (``bench`` / ``op_bench`` /
    ``health_check`` / ``train_epoch`` / ``imported_bench``); ``label``
    distinguishes variants of one producer (compare only builds series
    within one ``(kind, label)`` group).  ``legs`` are bench-style
    ``{"metric", "value", "unit", ...}`` rows; ``trace_dir`` folds in
    the per-span-name aggregate rows; ``labels=`` narrows the monitor
    snapshot to the given name prefixes (see ``monitor.snapshot``).
    ``include_snapshot=False`` skips the registry snapshot AND the
    derived summary entirely — the shape for a producer that appends
    MANY records per process (bench's per-leg appends): process-
    cumulative counters are only meaningful once per run, and a
    within-run ramp (leg 1 compiled 3 sites, leg 5 has 15) must not
    read as a cross-run regression."""
    if include_snapshot:
        snap = monitor.snapshot(labels=labels)
        summary = _summary_from_snapshot(snap)
        flight_events = snap.pop("flight_events", {})
    else:
        snap, summary = None, {}
        try:
            from paddle_tpu_torch.framework.observability import flight
            flight_events = flight.kind_totals()
        except Exception:          # noqa: BLE001
            flight_events = {}
    rec: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "kind": str(kind),
        "label": label,
        "run_id": _run_id(),
        "ts": time.time(),
        "meta": meta if meta is not None else run_meta(),
        "summary": summary,
        "snapshot": snap,
        "flight_events": flight_events,
        "legs": list(legs or []),
    }
    if trace_dir:
        try:
            from paddle_tpu_torch.framework.observability import span_summary
            rows = span_summary(trace_dir)
            if rows:
                rec["trace_summary"] = rows
        except Exception:          # noqa: BLE001 — capture never crashes
            rec["trace_summary"] = None
        try:
            # per-run blame vector (framework/blame.py): the causal
            # critical-path split of the traced steps.  The
            # blame_<cat>_ms per-step means join the summary series so
            # `perf_report compare` can flag a bottleneck SHIFT
            # (compute -> ps_wait at flat step time) cross-run by name.
            # ``blame_result`` short-circuits the trace re-read for a
            # caller that already computed it (health_check's report)
            from paddle_tpu_torch.framework import blame as _blame
            res = blame_result if blame_result is not None else \
                _blame.compute_blame(_blame.load_trace_dir(trace_dir))
            if res.get("n_steps"):
                rec["blame"] = {
                    "n_steps": res["n_steps"],
                    "totals_ms": res["totals_ms"],
                    "per_step_ms": res["per_step_ms"],
                    "shares": res["shares"],
                    "top_category": res["top_category"],
                    "unresolved_links": res["unresolved_links"]}
                rec["summary"].update(_blame.summary(res))
        except Exception:          # noqa: BLE001 — capture never crashes
            pass
    if extra:
        rec.update(extra)
    return rec


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

class RunLedger:
    """Append-only JSONL run store, safe for concurrent writers.

    Appends take an ``fcntl`` lock on ``<path>.lock`` (the
    ``elastic.FileStore`` locking idiom — independently-launched
    processes on one host serialize) and are TRUE appends (O_APPEND +
    flush + fsync): one record costs O(1) I/O however long the history
    grows, where a tmp+rename rewrite would make the cumulative cost
    quadratic.  Crash-safety holds without the rename: a crash
    mid-append can only tear the LAST line, which every reader skips
    (``runlog_skipped_records_total``) and the next append isolates by
    terminating it with a newline first — committed records are never
    touched, one bad line never poisons the history behind it.

    :meth:`append` NEVER raises: ledger I/O faults (proven by the
    ``runlog.observe`` chaos point) degrade to a ``runlog.write_error``
    flight event + ``runlog_write_errors_total`` and return False — the
    run being recorded always survives its recorder."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lockpath = self.path + ".lock"
        self._skipped_seen = 0     # counter dedupe across read passes

    # -- write --------------------------------------------------------------
    def append(self, record: dict) -> bool:
        """Append one record; returns True when it committed.  Failures
        (injected via ``runlog.observe`` or real OS errors) are
        swallowed, counted, and flight-recorded — never raised."""
        try:
            chaos.fault_point("runlog.observe",
                              meta={"op": "append", "path": self.path})
            payload = (json.dumps(record, default=str) + "\n").encode()
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            import fcntl
            with open(self._lockpath, "a+") as lf:
                fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
                try:
                    with open(self.path, "ab") as f:
                        f.seek(0, os.SEEK_END)
                        if f.tell() > 0:
                            # terminate a torn tail so the bad
                            # half-line stays isolated (readers skip
                            # it) instead of swallowing this record
                            # into it
                            with open(self.path, "rb") as rf:
                                rf.seek(-1, os.SEEK_END)
                                torn = rf.read(1) != b"\n"
                            if torn:
                                f.write(b"\n")
                        f.write(payload)
                        f.flush()
                        os.fsync(f.fileno())
                finally:
                    fcntl.flock(lf.fileno(), fcntl.LOCK_UN)
            monitor.stat_add("runlog_records_written_total")
            return True
        except Exception as e:     # noqa: BLE001 — recorder never crashes
            monitor.stat_add("runlog_write_errors_total")
            try:
                from paddle_tpu_torch.framework.observability import flight
                flight.record("runlog.write_error", severity="warn",
                              path=self.path, error=repr(e))
            except Exception:      # noqa: BLE001
                pass
            return False

    # -- read ---------------------------------------------------------------
    def read(self) -> List[dict]:
        """Every parseable record, in append order.  Malformed lines
        (torn tail, hand-edited junk — including a line torn inside a
        multi-byte character: undecodable bytes degrade to replacement
        chars, which JSON rejects, which the skip path absorbs) are
        skipped and counted into ``runlog_skipped_records_total``;
        records from a NEWER schema version are returned as-is
        (consumers read known fields via ``.get`` — skew degrades,
        never crashes).  ``runlog_skipped_records_total`` grows with
        CORRUPTION, not with read frequency: this ledger handle only
        counts skips beyond the most it has already reported."""
        try:
            with open(self.path, encoding="utf-8",
                      errors="replace") as f:
                text = f.read()
        except OSError:
            return []
        records: List[dict] = []
        skipped = 0
        for ln in text.splitlines():
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                skipped += 1
                continue
            if not isinstance(rec, dict):
                skipped += 1
                continue
            records.append(rec)
        if skipped > self._skipped_seen:
            monitor.stat_add("runlog_skipped_records_total",
                             skipped - self._skipped_seen)
            self._skipped_seen = skipped
        return records

    def records(self, kind: Optional[str] = None,
                label: Optional[str] = None) -> List[dict]:
        """:meth:`read`, filtered by ``kind`` and/or ``label``."""
        out = self.read()
        if kind is not None:
            out = [r for r in out if r.get("kind") == kind]
        if label is not None:
            out = [r for r in out if r.get("label") == label]
        return out

    def __len__(self) -> int:
        return len(self.read())


# ---------------------------------------------------------------------------
# historical BENCH_r*.json import
# ---------------------------------------------------------------------------

def bench_record_to_legs(text: str) -> List[dict]:
    """Parse bench output lines (one JSON object per line, ``{"metric",
    "value", "unit", "vs_baseline"}``) out of free text — the BENCH
    artifacts keep them inside a captured-stdout ``tail`` that
    also holds warnings and partial lines."""
    legs = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln.startswith("{"):
            continue
        try:
            rec = json.loads(ln)
        except ValueError:
            continue
        if isinstance(rec, dict) and "metric" in rec and "value" in rec:
            legs.append(rec)
    return legs


def import_bench_file(path: str) -> Optional[dict]:
    """One historical ``BENCH_r*.json`` artifact → one
    ``imported_bench`` RunRecord (None when the file holds no parseable
    bench legs).  The record's ``label`` is ``"BENCH"`` so the imported
    rounds form ONE compare series; ``run`` keeps the round."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(doc, dict):
        legs = bench_record_to_legs(str(doc.get("tail", "")))
        n = doc.get("n")
    else:
        legs, n = [], None
    if not legs:
        return None
    return {
        "schema_version": SCHEMA_VERSION,
        "kind": "imported_bench",
        "label": "BENCH",
        "run_id": os.path.basename(path),
        "run": n,
        "ts": None,
        "meta": {"source": os.path.basename(path)},
        "summary": {},
        "snapshot": None,
        "flight_events": {},
        "legs": legs,
    }
