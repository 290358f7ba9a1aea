"""Central cluster telemetry collector — the fleet-level view (port of
paddle_tpu/framework/collector.py, host Python as there: its frames, view
and straggler scores are the reference's, ``tests/test_torch_collector.py``).

Every observability plane before this one is per-process: each worker
writes its own span file, keeps its own monitor registry, and runs its
own detectors, so a straggling worker, a skewed PS shard, or a hot
embedding row is invisible until someone hand-merges files after the
run.  This module is the missing aggregation point, three parts on the
design center the whole stack shares (telemetry must never slow or
crash the thing it observes):

* :class:`CollectorClient` — the **fire-and-forget push path** every
  process uses.  ``push(payload)`` enqueues onto a bounded queue
  (``FLAGS_collector_queue_capacity``); a background sender ships each
  payload over the PS RPC wire framing (length-prefixed JSON header —
  byte-compatible with ``ps/service.py``'s ``_send_msg``/``_recv_msg``,
  re-implemented header-only here so the collector stays off the
  PS/device-table import chain) with the ``collector.rpc`` chaos point
  at its head.  A full
  queue, a dead collector, a timeout, or an injected fault is a DROP,
  counted into ``collector_dropped_total`` — the pushing train loop is
  bit-identical to a collector-less run (pinned by the CI gate).
  Pushes carry a per-process monotonic ``seq`` so the collector can see
  its own losses (gaps) without any acknowledgement protocol.

* :class:`CollectorServer` — the **aggregation + cross-worker
  detection** service.  ``report`` ops fold each process's
  ``monitor.snapshot()`` deltas, span summaries, flight-event deltas
  (merged in per-process-seq order — stable under clock skew), and PS
  table telemetry (per-shard request counts + the bounded
  :class:`~paddle_tpu_torch.distributed.ps.device_table.HotRowSketch` top-k)
  into one cluster state.  The existing ``health.Detector`` runs
  *across* workers: each trainer's per-interval step-time mean feeds a
  per-worker detector, and a **straggler score** (interval mean over
  the leave-one-out median of its peers) names the slow rank —
  surfaced in the live view, reported to
  ``ElasticAgent.note_stragglers`` via ``on_straggler``, and stamped
  into a cluster-level run-ledger record
  (:meth:`CollectorServer.capture_record`) that ``perf_report
  compare`` gates cross-run.

* ``tools/cluster_top.py`` — the **live text view** rendered from the
  collector's ``view`` op (or, collector-less, by scraping PS ``stat``
  ops): per-worker step p50/p99, stall %, RPC latency, anomaly/flight
  counts, straggler flags, hot tables.

Wiring: ``launch`` exports ``PADDLE_COLLECTOR_ENDPOINT`` (and
``PADDLE_ROLE``) to every child — server AND trainer roles — when
``--collector`` (in-launcher collector) or ``--collector_endpoint`` is
given; :func:`auto_reporter` turns that env (or
``FLAGS_collector_endpoint``) into a started push-mode
``MetricsReporter`` in one call.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import socketserver
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch.framework import chaos, locks, monitor
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.framework.observability import flight, tracer

__all__ = ["CollectorClient", "CollectorServer",
           "aggregate_table_shards", "auto_reporter",
           "collector_endpoint", "local_payload", "merge_flight_events",
           "request", "serve"]

VIEW_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# wire framing — byte-compatible with the PS RPC protocol
# (ps/service.py _send_msg/_recv_msg), restricted to header-only
# messages: telemetry is pure JSON, and re-implementing the 40 lines
# here keeps the collector off the PS/accelerator import chain — a
# launcher-hosted collector never touches device tables or numpy
# buffer plumbing, and no device ever gets initialized on its account
# ---------------------------------------------------------------------------

def _recvall(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _send(sock: socket.socket, header: dict) -> int:
    meta = dict(header)
    meta["__bufs__"] = []
    hb = json.dumps(meta, default=str).encode()
    msg = struct.pack("<I", len(hb)) + hb
    sock.sendall(msg)
    return len(msg)


def _recv(sock: socket.socket) -> dict:
    (hlen,) = struct.unpack("<I", _recvall(sock, 4))
    header = json.loads(_recvall(sock, hlen))
    for _spec in header.pop("__bufs__", []) or []:
        # drain any buffers a PS-framing peer attached; telemetry
        # itself never carries them
        (blen,) = struct.unpack("<Q", _recvall(sock, 8))
        _recvall(sock, blen)
    return header


def request(endpoint: str, header: dict,
            timeout: Optional[float] = None) -> dict:
    """One-shot RPC over the PS framing: dial ``endpoint``, send
    ``header``, return the reply header.  What ``cluster_top`` uses for
    both the collector's ``view`` op and the PS ``stat`` fallback
    scrape (same wire format on both services)."""
    host, port = endpoint.rsplit(":", 1)
    t = float(flag("collector_timeout")) if timeout is None else timeout
    with socket.create_connection((host, int(port)), timeout=t) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send(s, header)
        return _recv(s)


def collector_endpoint() -> Optional[str]:
    """The collector endpoint this process should push to:
    ``PADDLE_COLLECTOR_ENDPOINT`` (the launcher's per-child env) wins
    over ``FLAGS_collector_endpoint``; None when neither is set."""
    ep = os.environ.get("PADDLE_COLLECTOR_ENDPOINT") \
        or str(flag("collector_endpoint") or "")
    return ep or None


# ---------------------------------------------------------------------------
# payload assembly (the pushing side)
# ---------------------------------------------------------------------------

_HIST_KEYS = ("count", "sum", "mean", "p50", "p95", "p99", "max")

# incremental span-file cursor: the push path must not re-read (and
# re-aggregate) the whole ever-growing span file every interval — that
# is the O(n²)-cumulative-I/O shape the run ledger explicitly rejected.
# Per span file we remember the byte offset already folded in and keep
# cumulative per-name aggregates (count/total/max/errors exact; p99
# over a bounded window of recent durations)
_SPAN_WINDOW = 512
_span_cursors: Dict[str, dict] = {}
_span_lock = locks.lock("collector.spans")


def _own_span_rows(path: str) -> List[dict]:
    with _span_lock:
        cur = _span_cursors.get(path)
        if cur is None:
            cur = _span_cursors[path] = {"offset": 0, "names": {},
                                         "ino": None}
        try:
            with open(path, "rb") as f:
                st = os.fstat(f.fileno())
                if st.st_ino != cur.get("ino") or \
                        st.st_size < cur["offset"]:
                    # segment rotated (FLAGS_trace_max_mb) or truncated:
                    # this is a FRESH file — restart the byte cursor at
                    # 0 (everything in it is new, so no double count;
                    # spans of the rotated-away segment that were never
                    # read are simply gone — the tracer counts them in
                    # trace_spans_dropped_total).  The per-name
                    # aggregates keep accumulating across segments
                    cur["offset"] = 0
                    cur["ino"] = st.st_ino
                f.seek(cur["offset"])
                chunk = f.read()
        except OSError:
            return []
        if chunk:
            # fold only COMPLETE lines; a torn tail stays unconsumed
            # until its newline lands
            cut = chunk.rfind(b"\n") + 1
            cur["offset"] += cut
            for line in chunk[:cut].splitlines():
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") != "span":
                    continue
                name = str(rec.get("name", "?"))
                ms = float(rec.get("dur", 0.0)) / 1e3
                agg = cur["names"].get(name)
                if agg is None:
                    agg = cur["names"][name] = {
                        "count": 0, "total_ms": 0.0, "max_ms": 0.0,
                        "errors": 0, "recent": deque(maxlen=_SPAN_WINDOW)}
                agg["count"] += 1
                agg["total_ms"] += ms
                agg["max_ms"] = max(agg["max_ms"], ms)
                agg["errors"] += int(rec.get("status") == "error")
                agg["recent"].append(ms)
        rows = []
        for name, agg in cur["names"].items():
            recent = sorted(agg["recent"])
            p99 = recent[min(len(recent) - 1,
                             max(0, int(0.99 * len(recent) + 0.5) - 1))] \
                if recent else 0.0
            rows.append({"name": name, "count": agg["count"],
                         "total_ms": round(agg["total_ms"], 3),
                         "mean_ms": round(agg["total_ms"] / agg["count"],
                                          3) if agg["count"] else 0.0,
                         "p99_ms": round(p99, 3),
                         "max_ms": round(agg["max_ms"], 3),
                         "errors": agg["errors"]})
        rows.sort(key=lambda r: r["total_ms"], reverse=True)
        return rows


def local_payload(since_seq: int = 0, extra: Optional[dict] = None,
                  labels=None) -> dict:
    """One telemetry payload for this process: the full
    ``monitor.snapshot()`` stats + histogram summaries (the collector
    diffs consecutive payloads itself, so the pusher stays stateless),
    the flight-event DELTA since ``since_seq`` (each event stamped with
    its per-process monotonic seq), and — when tracing is armed — this
    process's own span-summary rows (folded incrementally: each push
    reads only the span file's new bytes; p99 is over the last
    ``_SPAN_WINDOW`` spans per name, count/total/max/errors exact).
    ``extra`` merges producer-specific sections in (e.g. the PS
    server's per-table telemetry)."""
    snap = monitor.snapshot(labels=labels)
    hists = {name: {k: rec.get(k) for k in _HIST_KEYS}
             for name, rec in snap.get("histograms", {}).items()}
    payload: Dict[str, Any] = {
        "stats": snap.get("stats", {}),
        "hists": hists,
        "flight_events": snap.get("flight_events", {}),
        "flight": flight.since(since_seq),
        "flight_last_seq": flight.last_seq(),
    }
    if tracer.enabled:
        try:
            rows = _own_span_rows(tracer.path())
            if rows:
                payload["spans"] = rows
        except Exception:  # noqa: BLE001 — telemetry never crashes
            pass
    try:
        # incident notices (postmortem plane): the CUMULATIVE bounded
        # queue ships whole each push — fire-and-forget pushes drop, so
        # the server dedups by id rather than the client draining
        from paddle_tpu_torch.framework import incident as _incident
        notices = _incident.drain_notices()
        if notices:
            payload["incidents"] = notices
    except Exception:  # noqa: BLE001 — telemetry never crashes
        pass
    if extra:
        payload.update(extra)
    return payload


def merge_flight_events(events_by_worker: Dict[Any, List[dict]]
                        ) -> List[dict]:
    """Merge per-process flight events into one stable order.  Within a
    process (= one group key), order follows the per-process monotonic
    ``seq`` (record order, whatever the wall clock did); across
    processes, events interleave by a MONOTONICIZED timestamp — each
    event's effective ts is the max of its own and every earlier
    same-process event's — so clock skew or a backwards wall clock can
    never reorder one process's events, and ties break
    deterministically on (group, seq).  Group keys need only sort
    consistently: plain worker names for dump-file merges, ``(worker,
    incarnation)`` pairs in the collector (a restarted worker's seq
    rewinds, so its incarnations are distinct seq streams and must not
    interleave by seq).  Each merged event carries its ``worker``
    (pre-stamped events keep theirs)."""
    keyed = []
    for key in sorted(events_by_worker, key=str):
        eff = float("-inf")
        worker = key[0] if isinstance(key, tuple) else key
        for ev in sorted(events_by_worker[key],
                         key=lambda e: e.get("seq", 0)):
            eff = max(eff, float(ev.get("ts", 0.0)))
            out = dict(ev)
            out.setdefault("worker", worker)
            keyed.append((eff, str(key), ev.get("seq", 0), out))
    keyed.sort(key=lambda t: (t[0], t[1], t[2]))
    return [ev for _, _, _, ev in keyed]


def aggregate_table_shards(by_shard: Dict[str, dict]) -> dict:
    """Fold per-shard table telemetry (each shard's latest cumulative
    ``{pulls, pushes, rows_pulled, hot_rows}``) into one table row:
    request totals, shard skew (max pulls over the per-shard mean), and
    the cluster-wide hot-row top-k — per-shard rows are disjoint by
    ``id % n`` routing, so summing per-shard counts never double
    counts.  ONE definition shared by the collector's ``view`` and
    ``cluster_top``'s collector-less PS-scrape fallback, so the two
    views cannot silently diverge."""
    shards = {w: {"pulls": int(t.get("pulls") or 0),
                  "pushes": int(t.get("pushes") or 0),
                  "rows_pulled": int(t.get("rows_pulled") or 0)}
              for w, t in by_shard.items()}
    pulls = [v["pulls"] for v in shards.values()]
    total = sum(pulls)
    skew = (max(pulls) / (total / len(pulls))) if total and pulls else 1.0
    hot: Dict[int, int] = {}
    for t in by_shard.values():
        for rid, cnt in (t.get("hot_rows") or []):
            hot[int(rid)] = hot.get(int(rid), 0) + int(cnt)
    hot_rows = sorted(hot.items(), key=lambda kv: (-kv[1], kv[0]))[:32]
    return {"pulls": total,
            "pushes": sum(v["pushes"] for v in shards.values()),
            "by_shard": shards,
            "shard_skew": round(skew, 4),
            "hot_rows": hot_rows}


# ---------------------------------------------------------------------------
# client: bounded-queue fire-and-forget pusher
# ---------------------------------------------------------------------------

class CollectorClient:
    """Fire-and-forget telemetry pusher.  ``push`` never blocks and
    never raises: a payload enqueued while the queue is full — or whose
    send hits a dead collector, a timeout, or an injected
    ``collector.rpc`` fault — is dropped and counted
    (``collector_dropped_total``).  The background sender keeps one
    persistent connection, redialing lazily after a failure; there are
    no retries (the next interval's push IS the retry, and a retry
    storm against a dead collector is exactly the interference this
    design exists to rule out)."""

    def __init__(self, endpoint: str, worker: Optional[str] = None,
                 role: Optional[str] = None,
                 capacity: Optional[int] = None,
                 timeout: Optional[float] = None):
        self.endpoint = str(endpoint)
        self.worker = worker or os.environ.get("PADDLE_TRACE_LABEL") \
            or os.environ.get("PADDLE_ELASTIC_WORKER_ID") \
            or f"pid{os.getpid()}"
        self.role = role or os.environ.get("PADDLE_ROLE") \
            or {"PSERVER": "server", "TRAINER": "trainer"}.get(
                os.environ.get("TRAINING_ROLE", ""), "worker")
        cap = int(flag("collector_queue_capacity")) if capacity is None \
            else int(capacity)
        self.timeout = float(flag("collector_timeout")) if timeout is None \
            else float(timeout)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, cap))
        self._stop = threading.Event()
        self._seq = 0
        # guards the push seq AND the drop counter: _drop runs on both
        # the caller thread (queue full) and the sender thread (send
        # failure), and an unlocked += loses counts (PTA403)
        self._seq_lock = locks.lock("collector.client.seq")
        # per-INCARNATION identity (the PsClient._push_ident idiom): an
        # elastic-restarted worker reuses its name but restarts seq at
        # 1 — without this stamp the collector would read the rewound
        # stream as stale replays until it overtook the dead
        # incarnation's total, blinding it to exactly the workers
        # elastic restarts
        self.ident = f"{self.worker}~{os.urandom(4).hex()}"
        self.sent = 0
        self.dropped = 0
        self.send_errors = 0
        #: newest flight-event seq confirmed delivered — the delta
        #: cursor ``local_payload(since_seq=...)`` resumes from (a
        #: dropped push is re-shipped next interval; the collector's
        #: per-event seq dedup absorbs any overlap)
        self.flight_seq_sent = 0
        self._sock: Optional[socket.socket] = None
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="collector-push")
        self._thread.start()

    def push(self, payload: dict) -> bool:
        """Enqueue one payload; returns False when it was dropped
        (queue full or client stopped) — callers never wait."""
        monitor.stat_add("collector_pushes_total")
        if self._stop.is_set():
            self._drop()
            return False
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        item = {"op": "report", "worker": self.worker, "role": self.role,
                "ident": self.ident, "seq": seq, "time": time.time(),
                "payload": payload}
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            self._drop()
            return False

    def _drop(self):
        with self._seq_lock:
            self.dropped += 1
        monitor.stat_add("collector_dropped_total")

    def _close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _send_one(self, item: dict):
        # fire-and-forget by contract: a failed push is dropped and counted,
        # never retried or escalated into the observed process
        chaos.fault_point("collector.rpc",
                          meta={"endpoint": self.endpoint,
                                "seq": item["seq"]})
        # sender-thread-only state: _send_one/_close run exclusively on the
        # collector-push thread, so the lazy redial is single-threaded
        if self._sock is None:
            host, port = self.endpoint.rsplit(":", 1)
            self._sock = socket.create_connection(
                (host, int(port)), timeout=self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        _send(self._sock, item)
        reply = _recv(self._sock)
        if not reply.get("ok", False):
            raise ConnectionError(
                f"collector rejected report: {reply.get('error')}")
        self.sent += 1
        last = item["payload"].get("flight_last_seq")
        if isinstance(last, int) and last > self.flight_seq_sent:
            self.flight_seq_sent = last

    def _drain(self):
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    self._close()
                    return
                continue
            try:
                self._send_one(item)
            except (chaos.InjectedFault, ConnectionError, OSError,
                    struct.error, ValueError):
                self._close()
                self.send_errors += 1
                self._drop()
            finally:
                self._q.task_done()

    def stop(self, timeout: float = 2.0):
        """Stop the sender (best-effort final drain, bounded by
        ``timeout`` — a dead collector cannot wedge shutdown; the
        daemon thread is abandoned past the deadline)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)


# ---------------------------------------------------------------------------
# server: aggregation + cross-worker detection
# ---------------------------------------------------------------------------

class _WorkerState:
    """Everything the collector remembers about one reporting process."""

    __slots__ = ("role", "ident", "incarnations", "last_seq", "reports",
                 "gaps", "stale", "first_ts", "last_ts", "stats",
                 "hists", "spans", "flight_kind_totals", "flight_seen",
                 "step_count", "step_sum", "interval_means",
                 "straggler_score", "straggler", "detector_anomalies",
                 "incidents")

    def __init__(self, role: str, window: int):
        self.role = role
        self.ident = None        # per-incarnation stamp (restart detect)
        self.incarnations = 0
        self.last_seq = 0
        self.reports = 0
        self.gaps = 0            # pushes the process sent that never
        self.stale = 0           # arrived (seq holes = drops visible
        self.first_ts = None     # server-side, ack-free)
        self.last_ts = None
        self.stats: Dict[str, Any] = {}
        self.hists: Dict[str, dict] = {}
        self.spans: List[dict] = []
        self.flight_kind_totals: Dict[str, int] = {}
        self.flight_seen = 0
        self.step_count = 0
        self.step_sum = 0.0
        self.interval_means: deque = deque(maxlen=window)
        self.straggler_score = 1.0
        self.straggler = False
        self.detector_anomalies = 0
        self.incidents: Dict[int, dict] = {}  # id → notice (dedup'd)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: "CollectorServer" = self.server.collector  # type: ignore
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                header = _recv(sock)
            except (ConnectionError, OSError, struct.error, ValueError):
                return
            try:
                reply = srv._dispatch(header)
            except Exception as e:  # noqa: BLE001 — serve every peer
                reply = {"ok": False, "error": repr(e)}
            try:
                _send(sock, reply)
            except OSError:
                return
            if header.get("op") == "shutdown":
                return


class _TcpServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class CollectorServer:
    """The central telemetry collector: aggregates per-process reports
    into one cluster view and runs the existing ``health.Detector``
    ACROSS workers (see module docstring).

    ``on_straggler(scores: Dict[str, float], flagged: List[str])`` is
    invoked whenever the flagged set changes — the hook ``launch``
    wires to :meth:`ElasticAgent.note_stragglers
    <paddle_tpu_torch.distributed.elastic.ElasticAgent.note_stragglers>`, so
    the agent that today only sees hangs also sees stragglers.

    Deterministic: aggregation and scoring depend only on the payload
    sequence; the injectable ``clock`` stamps views, never gates
    anything."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 straggler_ratio: Optional[float] = None,
                 window: int = 8, flight_capacity: int = 1024,
                 worker_ttl: float = 60.0,
                 ledger_path: Optional[str] = None,
                 on_straggler: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.straggler_ratio = float(flag("collector_straggler_ratio")) \
            if straggler_ratio is None else float(straggler_ratio)
        self.window = int(window)
        # a worker silent for this long leaves the straggler scoring
        # peer set (its frozen step mean must not pollute the
        # leave-one-out median after a crash/shrink) and is marked
        # expired in the view; rows are kept for the post-mortem
        self.worker_ttl = float(worker_ttl)
        self.ledger_path = ledger_path
        self.on_straggler = on_straggler
        self.clock = clock or time.time
        self._lock = locks.lock("collector.server.state")
        self._workers: Dict[str, _WorkerState] = {}
        self._tables: Dict[str, dict] = {}
        self._flight: deque = deque(maxlen=max(1, int(flight_capacity)))
        self._flight_kind_totals: Dict[str, int] = {}
        self._detectors: Dict[str, Any] = {}
        self.reports_total = 0
        self._tcp = _TcpServer((host, port), _Handler)
        self._tcp.collector = self  # type: ignore
        self.host, self.port = self._tcp.server_address
        self.endpoint = f"{self.host}:{self.port}"
        self._thread: Optional[threading.Thread] = None
        # lifecycle latch: _serving is flipped from the owner thread
        # AND from the dispatch thread a remote `shutdown` op spawns —
        # the check-and-clear must be atomic or two racing shutdowns
        # both call BaseServer.shutdown() (PTA403/404, the bug class of
        # the original shutdown-on-never-started-server deadlock)
        self._life_lock = locks.lock("collector.server.lifecycle")
        self._serving = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "CollectorServer":
        with self._life_lock:
            self._serving = True
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True,
                                        name="collector-server")
        self._thread.start()
        return self

    def serve_forever(self):
        with self._life_lock:
            self._serving = True
        self._tcp.serve_forever()

    def shutdown(self):
        # BaseServer.shutdown() waits for a serve_forever loop to
        # acknowledge — on a server that was never started it would
        # wait forever, and an aggregation-only CollectorServer (tests
        # drive _handle_report directly) is legitimate.  The atomic
        # swap also makes concurrent shutdowns idempotent: exactly one
        # caller sees serving=True and stops the loop.
        with self._life_lock:
            serving, self._serving = self._serving, False
        if serving:
            self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, header: dict):
        op = header.get("op")
        if op == "hello":
            # carries the collector's time like the PS hello, so a
            # pusher could clock-sync against it the same way
            return {"ok": True, "service": "collector",
                    "time": time.time()}
        if op == "report":
            return self._handle_report(header)
        if op == "view":
            return {"ok": True, "view": self.view()}
        if op == "capture":
            rec, committed = self.capture_record(
                label=header.get("label"))
            return {"ok": True, "record": rec, "committed": committed}
        if op == "shutdown":
            threading.Thread(target=self.shutdown, daemon=True).start()
            return {"ok": True}
        return {"ok": False, "error": f"unknown collector op {op!r}"}

    # -- aggregation --------------------------------------------------------
    def _handle_report(self, header: dict):
        worker = str(header.get("worker") or "?")
        role = str(header.get("role") or "worker")
        ident = header.get("ident")
        seq = int(header.get("seq") or 0)
        payload = header.get("payload") or {}
        now = self.clock()
        with self._lock:
            st = self._workers.get(worker)
            if st is None:
                st = self._workers[worker] = _WorkerState(role,
                                                          self.window)
            st.role = role
            if ident is not None and ident != st.ident:
                # a NEW incarnation of this worker (elastic restart):
                # its push seq, cumulative step counters, and flight
                # seq all rewound — reset the cursors so the restarted
                # worker reports immediately instead of being read as
                # stale until it overtakes its dead predecessor.  The
                # windowed interval means survive: they are this worker
                # SLOT's history, and a bounded window ages them out
                st.ident = ident
                st.incarnations += 1
                st.last_seq = 0
                st.step_count = 0
                st.step_sum = 0.0
                st.flight_seen = 0
            if seq and seq <= st.last_seq:
                # a replayed/reordered push within one incarnation (an
                # identless legacy client restart is also read as
                # stale until it overtakes)
                st.stale += 1
                return {"ok": True, "stale": True}
            if seq:
                if st.last_seq:
                    st.gaps += max(0, seq - st.last_seq - 1)
                st.last_seq = seq
            st.reports += 1
            self.reports_total += 1
            st.first_ts = st.first_ts if st.first_ts is not None else now
            st.last_ts = now
            st.stats = dict(payload.get("stats") or {})
            st.hists = dict(payload.get("hists") or {})
            if payload.get("spans"):
                st.spans = list(payload["spans"])
            for kind, n in (payload.get("flight_events") or {}).items():
                st.flight_kind_totals[kind] = int(n)
            # flight delta merge: per-event per-process seq dedup, so a
            # re-shipped overlap (the pusher only advances its cursor
            # on a confirmed send) lands exactly once
            for ev in payload.get("flight") or []:
                es = int(ev.get("seq") or 0)
                if es and es <= st.flight_seen:
                    continue
                st.flight_seen = max(st.flight_seen, es)
                merged = dict(ev)
                merged["worker"] = worker
                # incarnation rides along so the view merge keeps each
                # restart's (rewound) seq stream separate
                merged["inc"] = st.incarnations
                self._flight.append(merged)
                kind = str(ev.get("kind", "?"))
                self._flight_kind_totals[kind] = \
                    self._flight_kind_totals.get(kind, 0) + 1
            # incident notices: the client ships its cumulative bounded
            # queue whole each push — dedup by id so a re-shipped
            # notice lands exactly once and a dropped push loses none
            for n in payload.get("incidents") or []:
                try:
                    nid = int(n.get("id"))
                except (TypeError, ValueError):
                    continue
                if nid not in st.incidents:
                    st.incidents[nid] = dict(n, worker=worker)
            # PS table telemetry (server roles): keep the LATEST
            # cumulative snapshot per shard — summing reports would
            # double-count
            for tname, t in (payload.get("tables") or {}).items():
                agg = self._tables.setdefault(tname, {"by_shard": {}})
                agg["by_shard"][worker] = dict(t)
            # per-interval step mean: the collector diffs consecutive
            # cumulative train_step_ms (count, sum) pairs
            h = st.hists.get("train_step_ms")
            interval_mean = None
            if h and h.get("count"):
                c, s = int(h["count"]), float(h.get("sum") or 0.0)
                if c > st.step_count:
                    interval_mean = (s - st.step_sum) / (c - st.step_count)
                    st.step_count, st.step_sum = c, s
                    st.interval_means.append(interval_mean)
            changed = self._rescore_locked(worker, interval_mean, now)
            scores = {w: ws.straggler_score
                      for w, ws in self._workers.items()
                      if ws.interval_means}
            flagged = sorted(w for w, ws in self._workers.items()
                             if ws.straggler)
        if changed and self.on_straggler is not None:
            try:
                self.on_straggler(scores, flagged)
            except Exception:  # noqa: BLE001 — a broken hook must not
                pass           # take the collector down
        return {"ok": True}

    def _expired_locked(self, st: _WorkerState, now: float) -> bool:
        return st.last_ts is not None and \
            now - st.last_ts > self.worker_ttl

    def _rescore_locked(self, worker: str,
                        interval_mean: Optional[float],
                        now: float) -> bool:
        """Re-derive straggler scores after one report (lock held).
        Score = the worker's windowed interval mean over the LEAVE-ONE-
        OUT median of its peers' — robust at any world size, and a
        2-worker cluster (the minimal acceptance shape) still separates
        cleanly where a pooled median would sit between the two.
        Workers silent past ``worker_ttl`` drop out of the peer set
        (and lose any straggler flag — dead is the hang watchdog's
        department, not this one's).  Returns True when the flagged set
        changed."""
        changed = False
        means = {}
        for w, ws in self._workers.items():
            if not ws.interval_means:
                continue
            if self._expired_locked(ws, now):
                if ws.straggler:
                    ws.straggler = False
                    changed = True
                    flight.record("collector.straggler", severity="info",
                                  worker=w, expired=True, flagged=False)
                continue
            means[w] = sum(ws.interval_means) / len(ws.interval_means)
        if len(means) >= 2:
            for w, m in means.items():
                ws = self._workers[w]
                peers = sorted(v for pw, v in means.items() if pw != w)
                # LOWER median: with an even peer count the averaged
                # median would be dragged up by a slow peer, deflating
                # a clean worker's score below 1.0 and (in a 3-worker
                # cluster) halving the straggler's — biasing the
                # denominator toward the fast half errs toward
                # flagging, never toward hiding
                med = peers[(len(peers) - 1) // 2]
                score = m / max(med, 1e-9)
                ws.straggler_score = score
                # don't flag off a single interval: a worker's first
                # report carries its compile-inflated first step, and a
                # one-sample flag would flap every fresh joiner through
                # the ElasticAgent hook (score is still reported)
                flagged = score >= self.straggler_ratio and \
                    len(ws.interval_means) >= 2
                if flagged != ws.straggler:
                    ws.straggler = flagged
                    changed = True
                    flight.record("collector.straggler",
                                  severity="warn" if flagged else "info",
                                  worker=w, score=round(score, 3),
                                  flagged=flagged)
                monitor.stat_set(f"cluster_straggler_score[{w}]",
                                 round(score, 4))
        # cross-worker detection with the EXISTING health.Detector: one
        # detector per worker over its own interval-mean stream catches
        # a rank *becoming* slow (the mid-run latency injection) even
        # before the cross-sectional ratio crosses the flag threshold
        if interval_mean is not None:
            det = self._detectors.get(worker)
            if det is None:
                from paddle_tpu_torch.framework.health import Detector
                det = self._detectors[worker] = Detector(
                    f"cluster_step_ms[{worker}]", warmup=4, window=32,
                    rel_floor=0.5, min_mad=5.0, clock=self.clock)
            a = det.update(interval_mean)
            if a is not None:
                ws = self._workers[worker]
                ws.detector_anomalies += 1
                monitor.stat_add("cluster_step_anomalies_total")
                flight.record("collector.step_anomaly", severity="warn",
                              worker=worker,
                              value=round(a.value, 4),
                              median=round(a.median, 4),
                              z=round(a.z, 2) if a.z == a.z else "inf")
        return changed

    # -- views --------------------------------------------------------------
    @staticmethod
    def _rpc_p99(hists: Dict[str, dict]) -> Optional[float]:
        p99s = [float(h.get("p99") or 0.0) for n, h in hists.items()
                if n.startswith("ps_client_rpc_ms_") and h.get("count")]
        return max(p99s) if p99s else None

    def view(self) -> dict:
        """One JSON-able cluster snapshot — what the ``view`` op
        returns and ``cluster_top`` renders."""
        now = self.clock()
        with self._lock:
            workers = {}
            for w, st in sorted(self._workers.items()):
                h = st.hists.get("train_step_ms") or {}
                expired = self._expired_locked(st, now)
                row = {
                    "role": st.role,
                    "reports": st.reports,
                    "last_seq": st.last_seq,
                    "incarnations": st.incarnations,
                    "gaps": st.gaps,
                    "age_s": round(now - st.last_ts, 3)
                    if st.last_ts is not None else None,
                    "expired": expired,
                    "steps_total": int(h.get("count") or 0),
                    "step_p50_ms": h.get("p50"),
                    "step_p99_ms": h.get("p99"),
                    "step_interval_mean_ms": round(
                        sum(st.interval_means) / len(st.interval_means),
                        4) if st.interval_means else None,
                    "input_stall_pct": st.stats.get("input_stall_pct"),
                    "ps_rpc_p99_ms": self._rpc_p99(st.hists),
                    "anomalies_total": int(
                        st.stats.get("health_anomalies_total") or 0),
                    "flight_total": sum(st.flight_kind_totals.values()),
                    "drops_reported": int(
                        st.stats.get("collector_dropped_total") or 0),
                    # expiry re-evaluated at READ time: a straggler
                    # that died (and took the cluster's reports with
                    # it) must not stay flagged in a view/capture taken
                    # hours later — dead is the hang watchdog's
                    # department
                    "straggler": st.straggler and not expired,
                    "straggler_score": round(st.straggler_score, 4),
                    "detector_anomalies": st.detector_anomalies,
                    "incidents_total": len(st.incidents),
                }
                workers[w] = row
            tables = {tname: aggregate_table_shards(agg["by_shard"])
                      for tname, agg in sorted(self._tables.items())}
            incidents = sorted(
                (dict(n) for st in self._workers.values()
                 for n in st.incidents.values()),
                key=lambda n: (str(n.get("worker")),
                               int(n.get("id") or 0)))
            flight_rows = merge_flight_events(
                self._group_flight_locked())
            return {
                "schema_version": VIEW_SCHEMA_VERSION,
                "ts": now,
                "endpoint": self.endpoint,
                "reports_total": self.reports_total,
                "workers": workers,
                "tables": tables,
                "stragglers": sorted(
                    w for w, row in workers.items() if row["straggler"]),
                "straggler_ratio": self.straggler_ratio,
                "flight_kind_totals": dict(self._flight_kind_totals),
                "flight": flight_rows[-64:],
                "incidents": incidents[-64:],
            }

    def _group_flight_locked(self) -> Dict[tuple, List[dict]]:
        groups: Dict[tuple, List[dict]] = {}
        for ev in self._flight:
            key = (ev.get("worker", "?"), ev.get("inc", 0))
            groups.setdefault(key, []).append(ev)
        return groups

    def straggler_report(self) -> dict:
        """The scores/flags alone (what tests and the ElasticAgent hook
        consume without a full view); expiry re-checked at read time
        like :meth:`view`."""
        now = self.clock()
        with self._lock:
            return {
                "scores": {w: round(st.straggler_score, 4)
                           for w, st in self._workers.items()
                           if st.interval_means},
                "stragglers": sorted(
                    w for w, st in self._workers.items()
                    if st.straggler and
                    not self._expired_locked(st, now)),
                "ratio": self.straggler_ratio,
            }

    # -- cluster-level run record ------------------------------------------
    def capture_record(self, label: Optional[str] = None):
        """Assemble a cluster-granularity RunRecord — the summary
        series ``perf_report compare`` gates over is CLUSTER-level (max
        step p99 across workers, max straggler score, straggler count,
        worst RPC p99, summed anomalies, summed push gaps) and the
        ``cluster`` section names every worker and flagged straggler.
        Appends to ``ledger_path`` when configured; returns
        ``(record, committed)``."""
        from paddle_tpu_torch.framework import runlog
        view = self.view()
        rows = view["workers"].values()

        def _agg(fn, key, dflt=None):
            vals = [r[key] for r in rows if r.get(key) is not None]
            return fn(vals) if vals else dflt

        summary: Dict[str, Any] = {}
        for key, out in (("step_p99_ms", "cluster_step_p99_ms_max"),
                         ("ps_rpc_p99_ms", "cluster_ps_rpc_p99_ms"),
                         ("input_stall_pct",
                          "cluster_input_stall_pct_max")):
            v = _agg(max, key)
            if v is not None:
                summary[out] = float(v)
        scores = [r["straggler_score"] for r in rows
                  if r.get("step_interval_mean_ms") is not None]
        if scores:
            summary["cluster_step_skew"] = float(max(scores))
        summary["cluster_straggler_count"] = len(view["stragglers"])
        summary["cluster_anomalies_total"] = float(
            sum(r["anomalies_total"] for r in rows))
        summary["cluster_report_gaps_total"] = float(
            sum(r["gaps"] for r in rows))
        rec = runlog.capture(
            "cluster", label=label or "cluster",
            include_snapshot=False,
            extra={"summary": summary,
                   "cluster": {"workers": view["workers"],
                               "stragglers": view["stragglers"],
                               "straggler_ratio": view["straggler_ratio"],
                               "tables": view["tables"]}})
        committed = False
        if self.ledger_path:
            committed = runlog.RunLedger(self.ledger_path).append(rec)
        return rec, committed


# collector-plane metric help texts (the # HELP satellite)
monitor.describe("cluster_straggler_score",
                 "per-worker step-time skew vs the leave-one-out peer "
                 "median (collector-side gauge)")
monitor.describe("cluster_step_anomalies_total",
                 "cross-worker step-time Detector anomalies seen by "
                 "the collector")
monitor.describe("ps_server_table_pulls",
                 "pull RPCs served per table (per-shard gauge)")
monitor.describe("ps_server_table_pushes",
                 "push RPCs applied per table (per-shard gauge)")


# ---------------------------------------------------------------------------
# process wiring
# ---------------------------------------------------------------------------

def auto_reporter(role: Optional[str] = None, worker: Optional[str] = None,
                  interval: Optional[float] = None,
                  path: Optional[str] = None, payload_extra=None):
    """Start a push-mode ``MetricsReporter`` against the configured
    collector endpoint (``PADDLE_COLLECTOR_ENDPOINT`` env — the
    launcher sets it for every child, server and trainer roles alike —
    or ``FLAGS_collector_endpoint``).  Returns the started reporter, or
    None when no endpoint is configured — the one-liner any process
    drops into its startup.  ``payload_extra`` (a callable returning a
    dict) merges producer-specific sections into every push (the PS
    server's per-table telemetry)."""
    ep = collector_endpoint()
    if ep is None:
        return None
    from paddle_tpu_torch.framework.observability import MetricsReporter
    return MetricsReporter(
        path,
        interval=float(flag("collector_interval"))
        if interval is None else interval,
        collector=ep, worker=worker, role=role,
        payload_extra=payload_extra).start()


def serve(port: int = 0, host: str = "127.0.0.1",
          ledger_path: Optional[str] = None, announce=print):
    """Blocking standalone collector entry (the launcher runs it
    in-process instead via ``--collector``)."""
    srv = CollectorServer(host=host, port=port, ledger_path=ledger_path)
    announce(f"COLLECTOR_READY {srv.endpoint}", flush=True)
    srv.serve_forever()


def _main():
    import argparse
    ap = argparse.ArgumentParser(
        description="paddle_tpu central telemetry collector")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--ledger", default=None,
                    help="append cluster RunRecords here on 'capture'")
    a = ap.parse_args()
    serve(a.port, a.host, ledger_path=a.ledger)


if __name__ == "__main__":
    _main()
