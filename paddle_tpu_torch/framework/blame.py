"""Causal critical-path analysis: per-step blame attribution (port of
paddle_tpu/framework/blame.py, host Python as there; it reads the port's
span files and ``torch.profiler``'s chrome trace, whose ``TrainStep``
ranges serve as step spans).

Five observability planes can say a step was SLOW; this module says
WHY.  The tracer records spans, with causal **links**
across the three async hand-offs (``Span.link`` /
``Tracer.link_next``): PS prefetch task -> consuming step
(``prefetch`` / ``sync_fallback``), ingest fetch task -> consuming step
(``ingest``), deferred coalesced push -> the ``push_pull`` RPC that
carries it (``deferred_push``).  This module reconstructs, per
``train.step`` span, the dependency DAG those edges plus the
parent/child tree define, computes the critical path through the
step's wall-clock **cycle**, and collapses it into a blame vector over
fixed categories:

========== ==========================================================
category   what claims it
========== ==========================================================
compute    unclaimed step time — the chip (or host math) was the path
ps_wait    PS spans (``ps.*``): sync pulls/pushes inside the step,
           linked prefetch tasks whose work ended inside this cycle,
           sync-fallback waits on doomed prefetches
ingest_wait ingest spans (``ingest.*``): linked fetch/transfer tasks
           the step had to wait out
collective spans carrying ``category: "collective"`` (cross-replica
           sync — in-jit collectives have no host span, so this is
           explicit-attr only)
compile    ``jit.compile`` spans (the health plane traces every
           signature-cache miss)
other      any other claiming span (host callbacks, user spans)
========== ==========================================================

**The cycle.**  A step's blame interval runs from the END of the
previous step span on the same lane/thread to this step's end (first
step: its own span).  The inter-step gap is where input waits live —
an ingest stall blocks the loop BETWEEN step spans — so blame over the
bare span would structurally miss the single biggest production
bottleneck (BENCH_r05's 98.98% input stall).  In a tight training loop
the gap is sub-percent, which is why the ``check`` gate can still
demand that categories sum to within tolerance of the measured step
span.

**Claims.**  Synchronous work = the step span's descendants (the
parent/child tree): a ``ps.pull`` issued inside the step blocked it
for its whole interval.  Asynchronous work = linked producers: a
prefetch issued during step N overlaps step N's compute harmlessly;
only the part of it inside step N+1's cycle blocked anything, so
claims are clipped to the cycle.  Producers whose spans outlive their
work (the prefetch span closes at consume time) carry a ``done_ts``
attr marking when the work actually finished — a pull fully hidden
behind the previous step claims ~nothing.  Overlapping claims resolve
by fixed priority (compile > collective > ps_wait > ingest_wait >
other); whatever no claim covers is ``compute``.  The categories
therefore PARTITION the cycle exactly — per-step blame sums to the
cycle length by construction.

Consumers: ``tools/perf_report.py blame`` (report + ``--check`` +
``--expect-top`` CI gates), ``runlog.capture`` (per-run ``blame``
summary -> ``blame_<cat>_ms`` compare series, so a bottleneck SHIFT is
a named cross-run regression even when total step time is flat), and
``tools/health_check.py`` (``--max-blame <cat>=<pct>`` gate).
:func:`publish` exports ``blame_<cat>_ms`` histograms and
``blame_<cat>_pct`` gauges into the monitor registry.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

__all__ = ["CATEGORIES", "LINK_CATEGORY", "categorize",
           "load_trace_dir", "from_chrome_trace", "build_dag",
           "compute_blame", "summary", "publish", "check",
           "format_blame"]

#: the fixed blame vocabulary — compare series, gates and the README
#: table all speak these names
CATEGORIES = ("compute", "ps_wait", "ingest_wait", "collective",
              "compile", "other")

#: claim priority when intervals overlap (a compile inside a pull span
#: is compile); ``compute`` is the unclaimed remainder, never a claim
_PRIORITY = ("compile", "collective", "ps_wait", "ingest_wait", "other")

#: link kind -> category (wins over the producer span's name rule:
#: a sync_fallback edge to a failed prefetch is PS wait whatever the
#: producer was called)
LINK_CATEGORY = {"prefetch": "ps_wait", "sync_fallback": "ps_wait",
                 "deferred_push": "ps_wait", "ingest": "ingest_wait"}


def categorize(name: str, attrs: Optional[dict] = None,
               link_kind: Optional[str] = None) -> str:
    """The blame category a span's time claims.  An explicit
    ``category`` attr wins (the collective hook — in-jit collectives
    have no natural host span name); then the link kind that reached
    it; then the span-name prefix rules."""
    cat = (attrs or {}).get("category")
    if cat in CATEGORIES:
        return str(cat)
    if link_kind is not None and link_kind in LINK_CATEGORY:
        return LINK_CATEGORY[link_kind]
    if name == "jit.compile":
        return "compile"
    if name.startswith("ps."):
        return "ps_wait"
    if name.startswith("ingest."):
        return "ingest_wait"
    if name.startswith(("collective.", "cc.")):
        return "collective"
    if name == "train.step":
        return "compute"
    return "other"


# ---------------------------------------------------------------------------
# span loading (the tracer's own format — no tools/ dependency)
# ---------------------------------------------------------------------------

def _norm(rec: dict, lane: int, shift_us: float) -> Optional[dict]:
    """One tracer span record -> the normalized shape the DAG walk
    uses: clock-corrected start/end (us), identity, links, attrs."""
    try:
        ts = float(rec.get("ts", 0.0)) + shift_us
        dur = float(rec.get("dur", 0.0))
    except (TypeError, ValueError):
        return None
    attrs = dict(rec.get("attrs") or {})
    done = attrs.get("done_ts")
    if isinstance(done, (int, float)):
        # producer-side completion stamp: same process clock as ts,
        # so it takes the same correction
        attrs["done_ts"] = float(done) + shift_us
    return {"id": rec.get("span"), "parent": rec.get("parent"),
            "name": str(rec.get("name", "?")), "ts": ts,
            "end": ts + dur, "dur": dur, "tid": rec.get("tid", 0),
            "lane": lane, "status": rec.get("status", "ok"),
            "attrs": attrs, "links": list(rec.get("links") or ())}


def load_trace_dir(trace_dir: str,
                   label: Optional[str] = None) -> List[dict]:
    """Read every ``trace_*.jsonl`` span file under ``trace_dir`` into
    normalized span dicts, clock-offset corrected onto one timeline
    (the ``trace_merge`` semantics, in-framework — the module that
    writes the format owns its readers).  Malformed lines are skipped,
    torn-trace tolerant."""
    pattern = "trace_*.jsonl" if label is None else \
        f"trace_{label}.jsonl"
    spans: List[dict] = []
    for lane, path in enumerate(sorted(glob.glob(
            os.path.join(trace_dir, pattern)))):
        shift_us = 0.0
        recs = []
        # a rotated previous segment (<path>.1, FLAGS_trace_max_mb) is
        # part of the same logical trace: read it FIRST so a producer
        # span rotated away between its write and its consumer's does
        # not read as a dangling link
        for seg in (path + ".1", path):
            try:
                with open(seg, encoding="utf-8",
                          errors="replace") as f:
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
                kind = rec.get("kind")
                if kind == "process":
                    try:
                        shift_us = float(
                            rec.get("clock_offset", 0.0)) * 1e6
                    except (TypeError, ValueError):
                        pass
                elif kind == "span":
                    recs.append(rec)
        # the LAST process meta wins (sync_clock re-emits) — apply the
        # final offset to every span of the lane, like trace_merge
        for rec in recs:
            sp = _norm(rec, lane, shift_us)
            if sp is not None:
                spans.append(sp)
    return spans


def from_chrome_trace(trace: dict) -> List[dict]:
    """Normalize a merged chrome-trace dict (``trace_merge.merge``
    output — timestamps already clock-corrected) into the same span
    shape :func:`load_trace_dir` produces, so blame can run on a saved
    merge artifact."""
    offsets = {}
    for f in (trace.get("metadata") or {}).get("files") or ():
        try:
            offsets[int(f.get("lane"))] = \
                float(f.get("clock_offset", 0.0)) * 1e6
        except (TypeError, ValueError):
            pass
    spans = []
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        links = args.pop("links", None)
        attrs = {k: v for k, v in args.items()
                 if k not in ("trace", "span", "parent", "status")}
        done = attrs.get("done_ts")
        if isinstance(done, (int, float)):
            # event ts was shifted by merge; the attr was not
            attrs["done_ts"] = float(done) + \
                offsets.get(ev.get("pid"), 0.0)
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        spans.append({"id": args.get("span"), "parent": args.get("parent"),
                      "name": str(ev.get("name", "?")), "ts": ts,
                      "end": ts + dur, "dur": dur,
                      "tid": ev.get("tid", 0),
                      "lane": ev.get("pid", 0),
                      "status": args.get("status", ev.get("cat", "ok")),
                      "attrs": attrs, "links": list(links or ())})
    return spans


# ---------------------------------------------------------------------------
# DAG reconstruction + critical-path blame
# ---------------------------------------------------------------------------

def build_dag(spans: List[dict]) -> dict:
    """Index the span set: ``by_id`` (span id -> span), ``children``
    (parent id -> child spans), and the count of links whose producer
    span is absent (``unresolved_links`` — the integrity number the
    ``--check`` gate demands be zero)."""
    by_id: Dict[str, dict] = {}
    for s in spans:
        if s.get("id") is not None:
            by_id[str(s["id"])] = s
    children: Dict[str, List[dict]] = {}
    unresolved = 0
    for s in spans:
        p = s.get("parent")
        if p is not None:
            children.setdefault(str(p), []).append(s)
        for lk in s.get("links") or ():
            if str(lk.get("span")) not in by_id:
                unresolved += 1
    return {"by_id": by_id, "children": children,
            "unresolved_links": unresolved}


def _producer_end(prod: dict) -> float:
    """When the producer's WORK finished: its ``done_ts`` attr when
    present (spans that stay open until consumed — the prefetch), else
    the span end."""
    done = (prod.get("attrs") or {}).get("done_ts")
    if isinstance(done, (int, float)):
        return min(float(done), prod["end"])
    return prod["end"]


def _step_claims(step: dict, dag: dict) -> List[tuple]:
    """Every (start, end, category, producer_name, edge_kind) interval
    that can claim part of this step's cycle: the step's descendants
    (synchronous work) and its linked producers, recursively through
    THEIR links (visited-guarded, so a malformed cyclic trace cannot
    hang the analysis)."""
    by_id, children = dag["by_id"], dag["children"]
    claims: List[tuple] = []
    seen = {str(step.get("id"))}
    lstack = list(step.get("links") or ())
    stack = list(children.get(str(step.get("id")), ()))
    while stack:
        d = stack.pop()
        did = str(d.get("id"))
        if did in seen:
            continue
        seen.add(did)
        cat = categorize(d["name"], d.get("attrs"))
        if cat != "compute":
            claims.append((d["ts"], d["end"], cat, d["name"], "child"))
        stack.extend(children.get(did, ()))
        # a descendant's own links (e.g. the push_pull RPC's
        # deferred_push edge back to the producing step) join the
        # producer walk — claims clip to the cycle, so a backward edge
        # to a past step claims nothing
        lstack.extend(d.get("links") or ())
    # linked producers (and their links, transitively)
    while lstack:
        lk = lstack.pop()
        prod = by_id.get(str(lk.get("span")))
        if prod is None:
            continue
        pid = str(prod["id"])
        if pid in seen:
            continue
        seen.add(pid)
        kind = lk.get("kind")
        cat = categorize(prod["name"], prod.get("attrs"), link_kind=kind)
        claims.append((prod["ts"], _producer_end(prod), cat,
                       prod["name"], str(kind)))
        lstack.extend(prod.get("links") or ())
    return claims


def compute_blame(spans: List[dict],
                  step_span: str = "train.step") -> dict:
    """Reconstruct the per-step dependency DAG and collapse its
    critical path into per-step blame vectors (see module docstring).
    Returns the full result dict: per-step rows, per-category totals /
    per-step means / shares, the top blocking edges, and the link-
    integrity count."""
    dag = build_dag(spans)
    steps = sorted((s for s in spans if s["name"] == step_span),
                   key=lambda s: (s["lane"], s["tid"], s["ts"]))
    prev_end: Dict[tuple, float] = {}
    step_rows: List[dict] = []
    totals = {c: 0.0 for c in CATEGORIES}
    edge_tot: Dict[tuple, float] = {}
    span_total_us = 0.0
    cycle_total_us = 0.0
    for s in steps:
        key = (s["lane"], s["tid"])
        t0, t1 = s["ts"], s["end"]
        c0 = prev_end.get(key)
        if c0 is None or c0 > t0:
            c0 = t0
        prev_end[key] = t1
        span_total_us += t1 - t0
        cycle_total_us += t1 - c0
        # clip claims to the cycle
        clipped = []
        pts = {c0, t1}
        for (a, b, cat, pname, kind) in _step_claims(s, dag):
            a2, b2 = max(a, c0), min(b, t1)
            if b2 <= a2:
                continue
            clipped.append((a2, b2, cat, pname, kind))
            pts.add(a2)
            pts.add(b2)
        # partition [c0, t1]: boundary sweep, highest-priority claim
        # wins each elementary interval, remainder is compute
        blame_us = {c: 0.0 for c in CATEGORIES}
        bounds = sorted(pts)
        for i in range(len(bounds) - 1):
            a, b = bounds[i], bounds[i + 1]
            if b <= a:
                continue
            winner = None
            for cat in _PRIORITY:
                if any(x <= a and b <= y for (x, y, c, _, _) in clipped
                       if c == cat):
                    winner = cat
                    break
            blame_us[winner or "compute"] += b - a
        for c, v in blame_us.items():
            totals[c] += v
        for (a2, b2, cat, pname, kind) in clipped:
            k = (pname, kind, cat)
            edge_tot[k] = edge_tot.get(k, 0.0) + (b2 - a2)
        step_rows.append({
            "step": len(step_rows), "ts": t0,
            "span_ms": round((t1 - t0) / 1e3, 6),
            "cycle_ms": round((t1 - c0) / 1e3, 6),
            "blame_ms": {c: round(v / 1e3, 6)
                         for c, v in blame_us.items()}})
    n = len(step_rows)
    totals_ms = {c: round(v / 1e3, 6) for c, v in totals.items()}
    per_step_ms = {c: round(v / 1e3 / n, 6) if n else 0.0
                   for c, v in totals.items()}
    total_us = sum(totals.values())
    shares = {c: round(v / total_us, 6) if total_us else 0.0
              for c, v in totals.items()}
    edges = [{"producer": k[0], "kind": k[1], "category": k[2],
              "blocked_ms": round(v / 1e3, 6)}
             for k, v in sorted(edge_tot.items(),
                                key=lambda kv: -kv[1])]
    top = max(shares, key=lambda c: shares[c]) if n else None
    return {"schema_version": 1, "step_span": step_span,
            "n_steps": n, "steps": step_rows,
            "totals_ms": totals_ms, "per_step_ms": per_step_ms,
            "shares": shares, "top_category": top,
            "span_ms_total": round(span_total_us / 1e3, 6),
            "cycle_ms_total": round(cycle_total_us / 1e3, 6),
            "edges": edges[:20],
            "unresolved_links": dag["unresolved_links"]}


# ---------------------------------------------------------------------------
# consumers: summary / publish / gates / rendering
# ---------------------------------------------------------------------------

def summary(result: dict) -> Dict[str, float]:
    """The scalar series a RunRecord carries (``runlog.capture``):
    per-step mean blocked ms per category — the direction-aware
    ``blame_<cat>_ms`` signals ``perf_report compare`` detects
    bottleneck SHIFTS over."""
    return {f"blame_{c}_ms": v
            for c, v in (result.get("per_step_ms") or {}).items()}


def publish(result: dict):
    """Export the blame vectors into the monitor registry: each step's
    per-category ms observed into a ``blame_<cat>_ms`` histogram, the
    run-level share into a ``blame_<cat>_pct`` gauge."""
    from paddle_tpu_torch.framework import monitor
    for row in result.get("steps") or ():
        for c, v in row["blame_ms"].items():
            monitor.observe(f"blame_{c}_ms", float(v))
    for c, v in (result.get("shares") or {}).items():
        monitor.stat_set(f"blame_{c}_pct", round(100.0 * float(v), 4))


def check(result: dict, tolerance: Optional[float] = 0.05,
          expect_top: Optional[str] = None) -> List[str]:
    """The acceptance gates.  Steps-found is always demanded.  With a
    ``tolerance`` (``perf_report blame --check``): every link must
    resolve and the blame categories must sum to within tolerance of
    the measured step span (they sum to the cycle exactly; a cycle far
    off the span means significant wall time lives BETWEEN step spans
    — fine for an input-stalled loop, lying for the back-to-back PS
    acceptance run, which is what this gate pins).  ``tolerance=None``
    skips the sum/integrity gates — the shape for ``--expect-top``
    alone, which must stay usable on exactly the stalled traces whose
    cycle exceeds their span.  ``expect_top`` demands the named
    category carry the largest share — the chaos leg's "injected
    ps.rpc latency must move blame to ps_wait" assertion.  Returns
    violations (empty = pass)."""
    bad = []
    if not result.get("n_steps"):
        bad.append(f"no {result.get('step_span')!r} spans in the trace")
        return bad
    if tolerance is not None:
        if result.get("unresolved_links"):
            bad.append(f"{result['unresolved_links']} unresolved "
                       "link(s): a producer span is missing from the "
                       "trace")
        blame_sum = sum((result.get("totals_ms") or {}).values())
        span_total = float(result.get("span_ms_total") or 0.0)
        if span_total <= 0:
            bad.append("zero total step-span time")
        elif abs(blame_sum - span_total) / span_total > tolerance:
            bad.append(
                f"blame sum {blame_sum:.3f} ms vs step span total "
                f"{span_total:.3f} ms: off by "
                f"{abs(blame_sum - span_total) / span_total:.1%} "
                f"(> {tolerance:.0%})")
    if expect_top is not None and result.get("top_category") != expect_top:
        bad.append(f"top blame category is "
                   f"{result.get('top_category')!r}, expected "
                   f"{expect_top!r} (shares: {result.get('shares')})")
    return bad


def format_blame(result: dict) -> str:
    """Render a blame result as a text report: the per-category table
    and the top blocking edges."""
    lines = [f"== blame ({result['n_steps']} x "
             f"{result['step_span']!r} step(s)) =="]
    if not result["n_steps"]:
        lines.append("no steps found")
        return "\n".join(lines)
    lines.append(
        f"step span total {result['span_ms_total']:.3f} ms, "
        f"cycle total {result['cycle_ms_total']:.3f} ms, "
        f"top category: {result['top_category']}")
    header = ("category", "total_ms", "ms/step", "share")
    table = [header]
    for c in CATEGORIES:
        table.append((c, f"{result['totals_ms'][c]:.3f}",
                      f"{result['per_step_ms'][c]:.3f}",
                      f"{result['shares'][c]:.1%}"))
    widths = [max(len(r[i]) for r in table) for i in range(len(header))]
    for j, row in enumerate(table):
        lines.append("  ".join(
            cell.ljust(widths[i]) if i == 0 else cell.rjust(widths[i])
            for i, cell in enumerate(row)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    edges = result.get("edges") or []
    if edges:
        lines.append("-- top blocking edges --")
        for e in edges[:8]:
            lines.append(f"  {e['producer']} [{e['kind']} -> "
                         f"{e['category']}]: {e['blocked_ms']:.3f} ms")
    if result.get("unresolved_links"):
        lines.append(f"UNRESOLVED LINKS: {result['unresolved_links']}")
    return "\n".join(lines)
