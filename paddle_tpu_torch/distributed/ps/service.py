"""The parameter server's TCP transport (port of paddle_tpu/distributed/
ps/service.py).

One shard (:class:`PsServer`) serves pull, push, the coalesced
``push_pull``, heartbeat, state, ``stat`` and the graph table's queries
for its tables; :class:`PsClient` routes rows to shards by ``id % n`` and
fans a request out on a thread pool, retrying a transport failure with
exponential backoff.  :class:`RemoteEmbeddingTable` is a host table's
pull / push surface over a client, so ``DistributedEmbedding``,
``AsyncCommunicator`` and ``PSTrainStep`` run on it unchanged.

The wire is the reference's, byte for byte: a little-endian u32 header
length, the JSON header (with ``__bufs__``: each buffer's shape and numpy
dtype name), then per buffer a u64 length and its raw bytes; no pickle.
A bf16 buffer is a torch tensor here (``wire.quantize_rows``): it goes on
the wire as its 16-bit words under the dtype name ``"bfloat16"``, as the
reference's ``ml_dtypes`` array does, and comes off it as such a tensor,
so either package's client talks to the other's server.

The host planes see the transport as the reference's: ``ps_<role>_*``
statistics and per-op latency histograms, the ``ps_rpc_ms`` health
signal, a ``ps.<op>`` span per logical RPC with a ``ps.rpc`` child per
attempt (its context on the header, re-opened by the server as
``ps.server.<op>``), the ``ps.rpc`` fault point before each send, and
``ps.retry`` / ``ps.mark_dead`` / ``ps.fence_rejected`` flight events.

The server is host-tier only: :data:`SERVER_BOOT` hides the card from
the child process before torch is imported, so a server never creates a
CUDA context.  ``serve()`` pushes the shard's telemetry to the cluster
collector when an endpoint is configured, as the reference's does.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.distributed.ps import HostEmbeddingTable
from paddle_tpu_torch.distributed.wire import (
    WIRE_DTYPES, dequantize_rows, normalize_wire, quantize_rows)
from paddle_tpu_torch.framework import (chaos, health, locks, monitor,
                                        observability)
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.framework.observability import flight

__all__ = ["PsServer", "PsClient", "RemoteEmbeddingTable",
           "HeartBeatMonitor", "TransportStats", "serve", "SERVER_BOOT"]


# ---------------------------------------------------------------------------
# wire protocol (reference :50-96)
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


def _wire_buf(b):
    """(numpy dtype name, raw bytes) of one buffer: a bf16 tensor as its
    16-bit words under ``"bfloat16"``, anything else as its numpy array."""
    if isinstance(b, torch.Tensor):
        t = b.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().tobytes()
        b = t.numpy()
    a = np.ascontiguousarray(b)
    return str(a.dtype), a.tobytes()


def _frame_msg(header: dict, bufs: Sequence = ()) -> bytes:
    """One wire frame: the header's JSON (with each buffer's shape and
    dtype) and the raw buffers."""
    meta = dict(header)
    raw = [_wire_buf(b) for b in bufs]
    meta["__bufs__"] = [{"shape": list(b.shape), "dtype": d}
                        for b, (d, _) in zip(bufs, raw)]
    hb = json.dumps(meta).encode()
    out = [struct.pack("<I", len(hb)), hb]
    for _, data in raw:
        out.append(struct.pack("<Q", len(data)))
        out.append(data)
    return b"".join(out)


def _send_msg(sock: socket.socket, header: dict, bufs: Sequence = ()) -> int:
    """Frame and send; returns the bytes put on the wire."""
    msg = _frame_msg(header, bufs)
    sock.sendall(msg)
    return len(msg)


def _from_wire(raw: bytes, spec: dict):
    shape = spec["shape"]
    if spec["dtype"] == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(spec["dtype"])).reshape(
        shape).copy()


def _recv_msg(sock: socket.socket):
    """Returns ``(header, bufs, wire_bytes)``."""
    (hlen,) = struct.unpack("<I", _recvall(sock, 4))
    header = json.loads(_recvall(sock, hlen))
    nbytes = 4 + hlen
    bufs = []
    for spec in header.pop("__bufs__", []):
        (blen,) = struct.unpack("<Q", _recvall(sock, 8))
        raw = _recvall(sock, blen)
        nbytes += 8 + blen
        bufs.append(_from_wire(raw, spec))
    return header, bufs, nbytes


class TransportStats:
    """Measured transport counters of one PS peer (reference :99-170): RPC
    count, errors, wire bytes each way and a latency histogram an op, kept
    on the instance and fed to the process's ``ps_<role>_*`` statistics
    and histograms; a client's latencies also feed the ``ps_rpc_ms``
    health signal.  At most ``MAX_OPS`` op keys (the last one ``other``):
    the op string comes off the wire."""

    MAX_OPS = 32

    def __init__(self, role: str = "client"):
        self.role = role
        self._lock = locks.lock("ps.transport.stats")
        self.rpcs = 0
        self.errors = 0
        self.bytes_sent = 0
        self.bytes_recv = 0
        self._per_op: Dict[str, Dict[str, int]] = {}
        self._lat: Dict[str, monitor.Histogram] = {}

    def record(self, op: str, sent: int, recv: int, seconds: float,
               error: bool = False):
        op = op or "?"
        ms = seconds * 1e3
        with self._lock:
            if op != "other" and op not in self._per_op and \
                    len(self._per_op) >= self.MAX_OPS - 1:
                op = "other"
            self.rpcs += 1
            self.errors += int(error)
            self.bytes_sent += sent
            self.bytes_recv += recv
            o = self._per_op.setdefault(
                op, {"rpcs": 0, "errors": 0, "bytes_sent": 0,
                     "bytes_recv": 0})
            o["rpcs"] += 1
            o["errors"] += int(error)
            o["bytes_sent"] += sent
            o["bytes_recv"] += recv
            h = self._lat.get(op)
            if h is None:
                h = self._lat[op] = monitor.Histogram(
                    f"ps_{self.role}_rpc_ms_{op}")
        h.record(ms)
        monitor.stat_add(f"ps_{self.role}_rpcs")
        monitor.stat_add(f"ps_{self.role}_bytes_sent", sent)
        monitor.stat_add(f"ps_{self.role}_bytes_recv", recv)
        if error:
            monitor.stat_add(f"ps_{self.role}_rpc_errors")
        monitor.observe(f"ps_{self.role}_rpc_ms_{op}", ms)
        if self.role == "client":
            health.observe("ps_rpc_ms", ms)

    def snapshot(self) -> dict:
        with self._lock:
            return {"role": self.role, "rpcs": self.rpcs,
                    "errors": self.errors,
                    "bytes_sent": self.bytes_sent,
                    "bytes_recv": self.bytes_recv,
                    "per_op": {k: dict(v)
                               for k, v in self._per_op.items()},
                    "latency_ms": {k: h.summary()
                                   for k, h in self._lat.items()}}


# ---------------------------------------------------------------------------
# heartbeat (reference :177-252)
# ---------------------------------------------------------------------------

class HeartBeatMonitor:
    """Last-beat time per worker; one silent for longer than ``timeout``
    is dead (reported once to ``on_dead``, by the optional thread of
    :meth:`start`).  A beat from a dead worker revives it and counts a
    flap (``flap_count``, ``on_revive(worker, flaps)``)."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        self._beats: Dict[str, float] = {}
        self._lock = locks.lock("ps.heartbeat")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.on_dead = None            # callback(worker_id)
        self.on_revive = None          # callback(worker_id, flap_count)
        self._reported: set = set()
        self._flaps: Dict[str, int] = {}

    def beat(self, worker: str):
        with self._lock:
            was_dead = worker in self._reported
            self._beats[worker] = time.monotonic()
            self._reported.discard(worker)
            if was_dead:
                self._flaps[worker] = self._flaps.get(worker, 0) + 1
                flaps = self._flaps[worker]
        if was_dead and self.on_revive is not None:
            self.on_revive(worker, flaps)

    def flap_count(self, worker: str) -> int:
        with self._lock:
            return self._flaps.get(worker, 0)

    def mark_dead(self, worker: str):
        """Report a peer dead now (a client whose RPC retries ran out)."""
        with self._lock:
            self._beats[worker] = time.monotonic() - (self.timeout + 1.0)
            already = worker in self._reported
            self._reported.add(worker)
        if not already and self.on_dead is not None:
            self.on_dead(worker)

    def workers(self) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            return {w: now - t for w, t in self._beats.items()}

    def dead_workers(self) -> List[str]:
        return [w for w, age in self.workers().items()
                if age > self.timeout]

    def _loop(self, interval: float):
        while not self._stop.wait(interval):
            for w in self.dead_workers():
                if w not in self._reported:
                    self._reported.add(w)
                    if self.on_dead is not None:
                        self.on_dead(w)

    def start(self, interval: float = 1.0):
        self._thread = threading.Thread(target=self._loop, args=(interval,),
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# server (reference :259-626)
# ---------------------------------------------------------------------------

class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: "PsServer" = self.server.ps          # type: ignore
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                header, bufs, n_in = _recv_msg(sock)
            except (ConnectionError, OSError):
                return
            t0 = time.perf_counter()
            ctx = srv.tracer.extract(header)
            span = srv.tracer.start_span(
                f"ps.server.{header.get('op')}", parent=ctx, detached=True,
                attrs={"worker": header.get("worker")}) \
                if ctx is not None else None
            try:
                reply, rbufs = srv._dispatch(header, bufs)
                ok = reply.get("ok", False)
            except Exception as e:                # noqa: BLE001
                reply, rbufs, ok = {"ok": False, "error": repr(e)}, [], False
            if span is not None:
                span.end(status="ok" if ok else "error")
            # counted before the reply leaves: a client reading the stats
            # the moment its reply arrives finds this request in them
            msg = _frame_msg(reply, rbufs)
            srv.transport.record(header.get("op"), len(msg), n_in,
                                 time.perf_counter() - t0, error=not ok)
            try:
                sock.sendall(msg)
            except OSError:
                return
            if header.get("op") in ("bye", "shutdown"):
                return


class _TcpServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PsServer:
    """One PS shard serving its ``tables`` ({name: host table, or a
    ``GraphTable`` for the ``graph`` op}).

    Pushes carry a ``(worker, seq)`` stamp the server claims before it
    applies them, so a retried push lands once; a failed apply releases
    its claim (``PUSH_SEQ_WINDOW`` stamps a worker, ``PUSH_SEQ_WORKERS``
    workers, least recently seen evicted).  Once ``set_epoch`` installs
    a membership epoch > 0, a push, ``push_pull`` or ``load_state``
    stamped with an older epoch (or none) is rejected, and only
    current-epoch byes count toward the ``n_workers`` quorum that shuts
    the server down."""

    PUSH_SEQ_WINDOW = 4096
    PUSH_SEQ_WORKERS = 256
    _FENCED_OPS = ("push", "push_pull", "load_state")

    def __init__(self, tables: Dict[str, HostEmbeddingTable],
                 host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout: float = 30.0,
                 n_workers: Optional[int] = None,
                 tracer: Optional[observability.Tracer] = None):
        self.tables = tables
        self.tracer = tracer if tracer is not None else observability.tracer
        self.monitor = HeartBeatMonitor(heartbeat_timeout)
        self.n_workers = n_workers
        self.epoch = 0
        self._bye_count = 0
        self._lock = locks.lock("ps.server.state")
        self.transport = TransportStats(role="server")
        self._table_stats: Dict[str, Dict[str, int]] = {}
        self._tstats_lock = locks.lock("ps.server.table_stats")
        self._push_seen: Dict[str, dict] = {}
        self._seen_lock = locks.lock("ps.server.push_seen")
        self._tcp = _TcpServer((host, port), _Handler)
        self._tcp.ps = self                        # type: ignore
        self.host, self.port = self._tcp.server_address
        self._thread: Optional[threading.Thread] = None

    # -- push dedup ---------------------------------------------------------
    def _reserve_push(self, header: dict) -> bool:
        """Claim this (worker, seq) stamp; False when it is claimed
        already (applied, or being applied now).  Unstamped pushes pass."""
        worker, seq = header.get("worker"), header.get("seq")
        if worker is None or seq is None:
            return True
        with self._seen_lock:
            seen = self._push_seen.pop(worker, None)
            if seen is None:
                seen = {}
            self._push_seen[worker] = seen          # most recent last
            if seq in seen:
                return False
            seen[seq] = True
            while len(seen) > self.PUSH_SEQ_WINDOW:
                seen.pop(next(iter(seen)))
            while len(self._push_seen) > self.PUSH_SEQ_WORKERS:
                self._push_seen.pop(next(iter(self._push_seen)))
        return True

    def _unreserve_push(self, header: dict):
        worker, seq = header.get("worker"), header.get("seq")
        with self._seen_lock:
            self._push_seen.get(worker, {}).pop(seq, None)

    def _is_dup_push(self, header: dict) -> bool:
        worker, seq = header.get("worker"), header.get("seq")
        with self._seen_lock:
            return seq is not None and \
                seq in self._push_seen.get(worker, ())

    def _apply_push(self, header: dict, ids: np.ndarray, grad_bufs) -> bool:
        """Decode and apply the gradient rows unless the stamp was claimed;
        returns whether it was a duplicate."""
        if not self._reserve_push(header):
            return True
        try:
            t = self.tables[header["table"]]
            grads = dequantize_rows(grad_bufs, header.get("wire", "f32"),
                                    cols=int(header.get("cols", 0) or 0))
            t.push(ids.astype(np.int64), grads, lr=header.get("lr"))
        except Exception:
            self._unreserve_push(header)
            raise
        return False

    # -- per-table telemetry ------------------------------------------------
    def _note_table(self, table: str, pulls: int = 0, pushes: int = 0,
                    rows_pulled: int = 0, rows_pushed: int = 0):
        with self._tstats_lock:
            t = self._table_stats.setdefault(
                table, {"pulls": 0, "pushes": 0, "rows_pulled": 0,
                        "rows_pushed": 0})
            t["pulls"] += pulls
            t["pushes"] += pushes
            t["rows_pulled"] += rows_pulled
            t["rows_pushed"] += rows_pushed
        if pulls:
            monitor.stat_add(f"ps_server_table_pulls[{table}]", pulls)
        if pushes:
            monitor.stat_add(f"ps_server_table_pushes[{table}]", pushes)

    def table_telemetry(self) -> Dict[str, dict]:
        """Requests and rows served a table, with its hot-row top-k."""
        with self._tstats_lock:
            out = {n: dict(t) for n, t in self._table_stats.items()}
        for name, t in self.tables.items():
            sketch = getattr(t, "hot_rows", None)
            if sketch is not None:
                out.setdefault(name, {"pulls": 0, "pushes": 0,
                                      "rows_pulled": 0, "rows_pushed": 0})
                out[name]["hot_rows"] = sketch.top()
        return out

    # -- request dispatch ---------------------------------------------------
    def _pull_reply(self, rows: np.ndarray, header: dict, **extra):
        """Rows encoded in the wire the request asked for, declared in the
        reply (an int4 reply also declares its logical width)."""
        wire = normalize_wire(header.get("wire", "f32"))
        hdr = {"ok": True, "wire": wire, **extra}
        if wire == "int4":
            hdr["cols"] = int(rows.shape[-1])
        return hdr, quantize_rows(rows, wire)

    def _dispatch(self, header: dict, bufs):
        op = header.get("op")
        we = header.get("epoch")
        if op in self._FENCED_OPS and self.epoch > 0 and \
                (we is None or we < self.epoch):
            flight.record("ps.fence_rejected", severity="warn", op=op,
                          worker=header.get("worker"), worker_epoch=we,
                          server_epoch=self.epoch)
            return {"ok": False,
                    "error": f"stale membership epoch {we} < {self.epoch}"
                             " — the job re-formed without this worker; "
                             "rejoin and refresh before pushing"}, []
        if op == "set_epoch":
            with self._lock:
                e = int(header["epoch"])
                if header.get("n_workers") is not None and e >= self.epoch:
                    self.n_workers = int(header["n_workers"])
                if e > self.epoch:
                    self._bye_count = 0    # a new generation's byes only
                self.epoch = max(self.epoch, e)
            return {"ok": True, "epoch": self.epoch,
                    "n_workers": self.n_workers}, []
        if op == "hello":
            try:
                wire = normalize_wire(header.get("wire", "f32"))
            except ValueError:
                wire = "f32"
            return {"ok": True, "wire": wire,
                    "wire_dtypes": list(WIRE_DTYPES),
                    "time": time.time()}, []
        if op == "pull":
            t = self.tables[header["table"]]
            ids = bufs[0].astype(np.int64)
            rows = t.pull(ids)
            self._note_table(header["table"], pulls=1,
                             rows_pulled=int(ids.size))
            return self._pull_reply(rows, header)
        if op == "push":
            dup = self._apply_push(header, bufs[0], bufs[1:])
            self._note_table(header["table"], pushes=1,
                             rows_pushed=int(np.asarray(bufs[0]).size))
            return {"ok": True, "dup": dup}, []
        if op == "push_pull":
            # apply the gradient rows (dedup-guarded), then serve the pull,
            # which a retry whose push was a duplicate still gets
            n_push = int(header.get("n_push_bufs", 0))
            dup = False
            if n_push:
                dup = self._apply_push(header, bufs[0], bufs[1:1 + n_push])
            t = self.tables[header["table"]]
            pull_ids = bufs[1 + n_push].astype(np.int64)
            rows = t.pull(pull_ids)
            self._note_table(
                header["table"], pulls=1, pushes=int(bool(n_push)),
                rows_pulled=int(pull_ids.size),
                rows_pushed=int(np.asarray(bufs[0]).size) if n_push else 0)
            return self._pull_reply(rows, header, dup=dup)
        if op == "graph":
            return self.tables[header["table"]].dispatch(header, bufs)
        if op == "heartbeat":
            self.monitor.beat(header["worker"])
            return {"ok": True, "time": time.time()}, []
        if op == "state":
            d = self.tables[header["table"]].state_dict()
            arrs = [np.asarray(d["table"])]
            has_g2 = "g2" in d
            if has_g2:
                arrs.append(np.asarray(d["g2"]))
            return {"ok": True, "optimizer": d["optimizer"],
                    "has_g2": has_g2}, arrs
        if op == "load_state":
            d = {"table": bufs[0], "optimizer": header["optimizer"]}
            if header.get("has_g2"):
                d["g2"] = bufs[1]
            self.tables[header["table"]].set_state_dict(d)
            return {"ok": True}, []
        if op == "stat":
            return {"ok": True,
                    "tables": {n: {"rows": getattr(t, "num_embeddings", 0),
                                   "dim": getattr(t, "embedding_dim", 0)}
                               for n, t in self.tables.items()},
                    "workers": self.monitor.workers(),
                    "dead": self.monitor.dead_workers(),
                    "flaps": {w: self.monitor.flap_count(w)
                              for w in self.monitor.workers()},
                    "wire_dtypes": list(WIRE_DTYPES),
                    "transport": self.transport.snapshot(),
                    "flight": flight.recent(32),
                    "health": health.snapshot(),
                    "table_stats": self.table_telemetry(),
                    "epoch": self.epoch}, []
        if op == "bye":
            stale = self.epoch > 0 and (we is None or we < self.epoch)
            done = False
            with self._lock:
                if not stale:
                    self._bye_count += 1
                if self.n_workers and self._bye_count >= self.n_workers:
                    done = True
            if done:
                threading.Thread(target=self.shutdown, daemon=True).start()
            return {"ok": True, "stale": stale, "remaining":
                    (self.n_workers - self._bye_count)
                    if self.n_workers else -1}, []
        if op == "shutdown":
            threading.Thread(target=self.shutdown, daemon=True).start()
            return {"ok": True}, []
        return {"ok": False, "error": f"unknown op {op!r}"}, []

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        """Serve on a background thread."""
        self.monitor.start()
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.monitor.start()
        self._tcp.serve_forever()

    def shutdown(self):
        self.monitor.stop()
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# client (reference :633-1173)
# ---------------------------------------------------------------------------

class _Conn:
    def __init__(self, endpoint: str, timeout: Optional[float] = None,
                 stats: Optional[TransportStats] = None):
        self.endpoint = endpoint
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self.timeout = float(flag("ps_rpc_timeout")) if timeout is None \
            else timeout
        self.stats = stats
        self.lock = locks.lock("ps.conn")
        # the first dial may fail (a dead peer in the set): rpc() redials
        try:
            self.sock = self._connect()
        except OSError:
            self.sock = None

    def _connect(self):
        sock = socket.create_connection(self._addr, timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def rpc(self, header: dict, bufs=()):
        # the fault point fires before the send, so a retry never applies
        # a push twice; its latency counts in the histograms
        t0 = time.perf_counter()
        sent = rcvd = 0
        try:
            chaos.fault_point("ps.rpc", meta={"op": header.get("op"),
                                              "endpoint": self.endpoint})
            with self.lock:
                if self.sock is None:
                    self.sock = self._connect()
                try:
                    sent = _send_msg(self.sock, header, bufs)
                    reply, rbufs, rcvd = _recv_msg(self.sock)
                except (ConnectionError, OSError):
                    # the stream may be mid-message: drop it under the lock
                    try:
                        self.sock.close()
                    except OSError:
                        pass
                    self.sock = None
                    raise
        except (ConnectionError, OSError):
            if self.stats is not None:
                self.stats.record(header.get("op"), sent, rcvd,
                                  time.perf_counter() - t0, error=True)
            raise
        if self.stats is not None:
            self.stats.record(header.get("op"), sent, rcvd,
                              time.perf_counter() - t0,
                              error=not reply.get("ok", False))
        if not reply.get("ok", False):
            raise RuntimeError(f"ps rpc {header.get('op')} failed: "
                               f"{reply.get('error')}")
        return reply, rbufs

    def close(self):
        if self.sock is None:
            return
        try:
            self.sock.close()
        except OSError:
            pass


class PsClient:
    """Routes rows to shards by ``id % n`` and fans a request out in
    parallel.

    A transport failure (a dropped connection, a timeout, the ``ps.rpc``
    fault) is retried ``max_retries`` times, sleeping ``backoff_base *
    2^attempt`` between attempts (``FLAGS_ps_rpc_max_retries``,
    ``FLAGS_ps_rpc_backoff_base``, ``FLAGS_ps_rpc_timeout``); an endpoint
    that runs out is added to ``dead_endpoints``, reported to
    ``monitor.mark_dead`` and ``on_endpoint_dead(endpoint, exc)``, and
    the error raised.  A server's error reply is not retried.  Every push
    carries a ``(worker, seq)`` stamp, scoped to this client's
    incarnation, that a retry or replay re-sends.

    ``wire_dtype`` (``FLAGS_ps_wire_dtype``): pulls ask for it and decode
    what the reply declares; int4 pulls and quantized pushes to a server
    wait for a ``hello`` listing the dtype, else go at f32."""

    def __init__(self, endpoints: Sequence[str],
                 worker_id: Optional[str] = None,
                 monitor: Optional[HeartBeatMonitor] = None,
                 max_retries: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 timeout: Optional[float] = None,
                 wire_dtype: Optional[str] = None,
                 tracer: Optional[observability.Tracer] = None):
        self.tracer = tracer if tracer is not None else observability.tracer
        self.transport = TransportStats(role="client")
        self.endpoints = list(endpoints)
        self._conns = [_Conn(ep, timeout=timeout, stats=self.transport)
                       for ep in self.endpoints]
        self._pool = ThreadPoolExecutor(max_workers=max(
            2, len(self.endpoints)))
        self.worker_id = worker_id or f"worker-{os.getpid()}"
        self.epoch: Optional[int] = None
        self.monitor = monitor
        self.max_retries = int(flag("ps_rpc_max_retries")) \
            if max_retries is None else int(max_retries)
        self.backoff_base = float(flag("ps_rpc_backoff_base")) \
            if backoff_base is None else float(backoff_base)
        self.wire_dtype = normalize_wire(
            flag("ps_wire_dtype") if wire_dtype is None else wire_dtype)
        self._push_wires: Dict[int, str] = {}
        self._dims: Dict[str, int] = {}
        self._push_ident = f"{self.worker_id}~{os.urandom(4).hex()}"
        self._seq = 0
        self._seq_lock = locks.lock("ps.client.seq")
        self.dead_endpoints: List[str] = []
        self._dead_lock = locks.lock("ps.client.dead")
        self.on_endpoint_dead = None       # callback(endpoint, exception)
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if self.tracer.enabled:
            try:
                self.sync_clock()
            except (ConnectionError, OSError, RuntimeError):
                pass

    @property
    def n(self):
        return len(self._conns)

    # -- retrying transport -------------------------------------------------
    def _rpc(self, s: int, header: dict, bufs=(),
             retries: Optional[int] = None, links=None):
        """One logical RPC to server ``s``: a ``ps.<op>`` span (with the
        caller's causal ``links``), a ``ps.rpc`` child an attempt whose
        context rides the header, retries on transport failures."""
        conn, ep = self._conns[s], self.endpoints[s]
        op = header.get("op")
        if self.epoch is not None:
            header.setdefault("epoch", self.epoch)
        retries = self.max_retries if retries is None else retries
        last: Optional[Exception] = None
        root = self.tracer.start_span(f"ps.{op}", detached=True,
                                      attrs={"endpoint": ep})
        for lk in links or ():
            root.link(lk.get("span"), lk.get("kind", "link"))
        for attempt in range(retries + 1):
            asp = self.tracer.start_span(
                "ps.rpc", parent=root, detached=True,
                attrs={"op": op, "endpoint": ep, "attempt": attempt})
            self.tracer.inject(header, asp)
            try:
                reply, rbufs = conn.rpc(header, bufs)
                asp.end(status="ok")
                root.end(status="ok")
                with self._dead_lock:
                    if ep in self.dead_endpoints:
                        self.dead_endpoints.remove(ep)
                if self.monitor is not None:
                    self.monitor.beat(ep)
                return reply, rbufs
            except RuntimeError as e:      # the server's error: no retry
                asp.end(status="error", exc=repr(e))
                root.end(status="error")
                raise
            except (ConnectionError, OSError) as e:
                last = e
                asp.end(status="error", exc=repr(e))
                flight.record("ps.retry", severity="warn", op=op,
                              endpoint=ep, attempt=attempt,
                              will_retry=attempt < retries, exc=repr(e))
                if attempt < retries:
                    time.sleep(self.backoff_base * (2 ** attempt))
        root.end(status="error", exc=repr(last))
        self._report_dead(ep, last)
        raise ConnectionError(
            f"ps endpoint {ep} dead after {retries + 1} attempts "
            f"of {header.get('op')!r}: {last!r}")

    def _report_dead(self, endpoint: str, exc: Optional[Exception]):
        flight.record("ps.mark_dead", severity="error", endpoint=endpoint,
                      exc=repr(exc))
        with self._dead_lock:
            if endpoint not in self.dead_endpoints:
                self.dead_endpoints.append(endpoint)
        if self.monitor is not None:
            self.monitor.mark_dead(endpoint)
        if self.on_endpoint_dead is not None:
            self.on_endpoint_dead(endpoint, exc)

    # -- wire negotiation and push stamps -----------------------------------
    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def set_wire_dtype(self, wire_dtype: str) -> str:
        """Change the preferred wire (each server's push wire is then
        negotiated again); returns the previous one."""
        prev = self.wire_dtype
        self.wire_dtype = normalize_wire(wire_dtype)
        self._push_wires.clear()
        return prev

    def _push_wire(self, s: int) -> str:
        """The wire of rows sent to server ``s``: resolved once by
        ``hello``; a server that does not know the op pins f32."""
        w = self._push_wires.get(s)
        if w is None:
            if self.wire_dtype == "f32":
                w = "f32"
            else:
                try:
                    reply, _ = self._rpc(
                        s, {"op": "hello", "wire": self.wire_dtype})
                    w = reply.get("wire", "f32") \
                        if self.wire_dtype in reply.get("wire_dtypes", ()) \
                        else "f32"
                except RuntimeError:
                    w = "f32"
            self._push_wires[s] = w
        return w

    def _pull_wire(self, s: int) -> str:
        """The wire a pull asks server ``s`` for: int4, added after the
        pull protocol, only where ``hello`` listed it."""
        if self.wire_dtype != "int4":
            return self.wire_dtype
        return self._push_wire(s)

    def _decode_pull(self, table: str, reply: dict, rbufs) -> np.ndarray:
        rows = dequantize_rows(rbufs, reply.get("wire", "f32"),
                               cols=int(reply.get("cols", 0) or 0))
        self._dims[table] = rows.shape[-1]
        return rows

    def _push_header(self, s: int, table: str, g: np.ndarray, lr, seq,
                     op: str = "push", **extra) -> dict:
        wire = self._push_wire(s)
        hdr = {"op": op, "table": table, "lr": lr, "wire": wire,
               "worker": self._push_ident, "seq": seq, **extra}
        if wire == "int4":
            hdr["cols"] = int(g.shape[-1])
        return hdr

    def _assemble(self, table: str, parts, n: int, shape) -> np.ndarray:
        """The pulled rows of each shard put back in request order."""
        first_dim = next((rows.shape[1] for _, _, rows in parts
                          if rows is not None), None)
        if first_dim is None:
            first_dim = self.table_dim(table)
        out = np.empty((n, first_dim), np.float32)
        for _, mask, rows in parts:
            if rows is not None:
                out[mask] = rows
        return out.reshape(tuple(shape) + (first_dim,))

    # -- sparse ops ---------------------------------------------------------
    def table_dim(self, table: str) -> int:
        """A table's row width, cached after the first pull or stat."""
        dim = self._dims.get(table)
        if dim is None:
            dim = self._dims[table] = self.stat()["tables"][table]["dim"]
        return dim

    def pull(self, table: str, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        flat = ids.reshape(-1)
        owner = flat % self.n
        tctx = self.tracer.current()

        def one(s):
            mask = owner == s
            if not mask.any():
                return s, mask, None
            with self.tracer.activate(tctx):
                reply, rows = self._rpc(
                    s, {"op": "pull", "table": table,
                        "wire": self._pull_wire(s)}, [flat[mask]])
            return s, mask, self._decode_pull(table, reply, rows)

        parts = list(self._pool.map(one, range(self.n)))
        return self._assemble(table, parts, flat.size, ids.shape)

    def push(self, table: str, ids: np.ndarray, grads: np.ndarray,
             lr: Optional[float] = None, seq: Optional[int] = None,
             links=None):
        """``seq`` re-sends an earlier stamp (a replay the server's dedup
        absorbs if the first copy landed); a fresh one when None.
        ``links`` (``[{"span", "kind"}]``) go on each shard's RPC span."""
        ids = np.asarray(ids, np.int64)
        flat = ids.reshape(-1)
        g = np.asarray(grads, np.float32).reshape(flat.size, -1)
        owner = flat % self.n
        seq = self._next_seq() if seq is None else seq
        tctx = self.tracer.current()

        def one(s):
            mask = owner == s
            if mask.any():
                with self.tracer.activate(tctx):
                    hdr = self._push_header(s, table, g, lr, seq)
                    self._rpc(s, hdr, [flat[mask]] + quantize_rows(
                        g[mask], hdr["wire"]), links=links)

        list(self._pool.map(one, range(self.n)))

    def push_pull(self, table: str, push_ids: Optional[np.ndarray],
                  push_grads: Optional[np.ndarray], pull_ids: np.ndarray,
                  lr: Optional[float] = None, seq: Optional[int] = None,
                  links=None) -> np.ndarray:
        """Apply one batch's gradient rows and pull the next batch's rows
        in one round trip a shard (a shard with only pushes gets a plain
        push); ``seq`` and ``links`` as in :meth:`push`."""
        pull_ids = np.asarray(pull_ids, np.int64)
        pflat = pull_ids.reshape(-1)
        powner = pflat % self.n
        if push_ids is None or len(np.asarray(push_ids)) == 0:
            return self.pull(table, pull_ids)
        gids = np.asarray(push_ids, np.int64).reshape(-1)
        g = np.asarray(push_grads, np.float32).reshape(gids.size, -1)
        gowner = gids % self.n
        seq = self._next_seq() if seq is None else seq
        tctx = self.tracer.current()

        def one(s):
            pmask = powner == s
            gmask = gowner == s
            if not pmask.any() and not gmask.any():
                return s, pmask, None
            with self.tracer.activate(tctx):
                if not pmask.any():
                    hdr = self._push_header(s, table, g, lr, seq)
                    self._rpc(s, hdr, [gids[gmask]] + quantize_rows(
                        g[gmask], hdr["wire"]), links=links)
                    return s, pmask, None
                wire = self._push_wire(s)
                payload = quantize_rows(g[gmask], wire) if gmask.any() \
                    else []
                hdr = self._push_header(s, table, g, lr, seq, op="push_pull",
                                        n_push_bufs=len(payload))
                reply, rows = self._rpc(
                    s, hdr, [gids[gmask]] + payload + [pflat[pmask]],
                    links=links)
                return s, pmask, self._decode_pull(table, reply, rows)

        parts = list(self._pool.map(one, range(self.n)))
        return self._assemble(table, parts, pflat.size, pull_ids.shape)

    # -- liveness -----------------------------------------------------------
    def heartbeat(self):
        """Beat every endpoint in parallel without retries (the next beat
        is the retry); a failing one is reported dead and skipped."""
        def one(s):
            try:
                self._rpc(s, {"op": "heartbeat",
                              "worker": self.worker_id}, retries=0)
            except (ConnectionError, OSError):
                pass
        list(self._pool.map(one, range(self.n)))

    def start_heartbeat(self, interval: float = 5.0):
        def loop():
            while not self._hb_stop.wait(interval):
                try:
                    self.heartbeat()
                except (RuntimeError, OSError):
                    pass
        self.heartbeat()
        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    # -- admin --------------------------------------------------------------
    def stat(self, server: int = 0):
        """Server ``server``'s stat reply, with this client's
        ``client_transport`` snapshot."""
        reply, _ = self._rpc(server, {"op": "stat"})
        for name, t in reply.get("tables", {}).items():
            if t.get("dim"):
                self._dims[name] = t["dim"]
        reply["client_transport"] = self.transport.snapshot()
        return reply

    def transport_stats(self) -> dict:
        return self.transport.snapshot()

    def sync_clock(self, server: int = 0) -> Optional[float]:
        """This process's clock offset to ``server`` (``server_time - (t0 +
        t1) / 2`` over one raw ``hello``, no retries), installed on the
        tracer; None from a server whose hello carries no time."""
        t0 = time.time()
        reply, _ = self._conns[server].rpc({"op": "hello", "wire": "f32"})
        t1 = time.time()
        if "time" not in reply:
            return None
        offset = float(reply["time"]) - (t0 + t1) / 2.0
        self.tracer.set_clock_offset(offset)
        return offset

    def set_epoch(self, epoch: int, fence_servers: bool = False,
                  n_workers: Optional[int] = None):
        """Stamp every later RPC with membership ``epoch``;
        ``fence_servers`` installs it on every server too (and
        ``n_workers`` as their bye quorum)."""
        self.epoch = int(epoch)
        if fence_servers:
            for s in range(self.n):
                self._rpc(s, {"op": "set_epoch", "epoch": self.epoch,
                              "n_workers": n_workers})

    def bye(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        for c in self._conns:
            try:
                header = {"op": "bye", "worker": self.worker_id}
                if self.epoch is not None:
                    header["epoch"] = self.epoch
                c.rpc(header)
            except (RuntimeError, OSError, ConnectionError):
                pass
            c.close()

    def shutdown_servers(self):
        for c in self._conns:
            try:
                c.rpc({"op": "shutdown"})
            except (RuntimeError, OSError, ConnectionError):
                pass


class RemoteEmbeddingTable:
    """A host table's pull / push surface over a :class:`PsClient`, with
    the coalesced :meth:`push_pull` that ``PSTrainStep``'s prefetch
    takes."""

    def __init__(self, client: PsClient, table: str, embedding_dim: int):
        self.client = client
        self.table = table
        self.embedding_dim = embedding_dim

    def pull(self, ids: np.ndarray) -> np.ndarray:
        return self.client.pull(self.table, ids)

    def push(self, ids: np.ndarray, grads: np.ndarray,
             lr: Optional[float] = None, seq: Optional[int] = None,
             links=None):
        self.client.push(self.table, ids, grads, lr=lr, seq=seq,
                         links=links)

    def push_pull(self, push_ids, push_grads, pull_ids,
                  lr: Optional[float] = None, seq: Optional[int] = None,
                  links=None) -> np.ndarray:
        return self.client.push_pull(self.table, push_ids, push_grads,
                                     pull_ids, lr=lr, seq=seq, links=links)


# ---------------------------------------------------------------------------
# standalone server (reference :1211-1262)
# ---------------------------------------------------------------------------

def serve(port: int, table_specs: Sequence[str], host: str = "127.0.0.1",
          n_workers: Optional[int] = None, heartbeat_timeout: float = 30.0,
          announce=print):
    """Serve host tables until ``n_workers`` byes or a shutdown; a table
    spec is ``name:rows:dim[:optimizer[:lr]]``.  Announces ``PS_READY
    host:port`` once listening.  With a collector endpoint configured
    (``PADDLE_COLLECTOR_ENDPOINT`` or ``FLAGS_collector_endpoint``) the
    shard pushes its telemetry, its tables' request counts and hot rows
    included, to the cluster collector, fire and forget."""
    tables = {}
    for spec in table_specs:
        parts = spec.split(":")
        name, rows, dim = parts[0], int(parts[1]), int(parts[2])
        optim = parts[3] if len(parts) > 3 else "adagrad"
        lr = float(parts[4]) if len(parts) > 4 else 0.05
        tables[name] = HostEmbeddingTable(rows, dim, optim, lr)
    srv = PsServer(tables, host=host, port=port,
                   heartbeat_timeout=heartbeat_timeout, n_workers=n_workers)
    from paddle_tpu_torch.framework import collector
    reporter = collector.auto_reporter(
        role="server",
        payload_extra=lambda: {"tables": srv.table_telemetry()})
    announce(f"PS_READY {srv.host}:{srv.port}", flush=True)
    try:
        srv.serve_forever()
    finally:
        if reporter is not None:
            reporter.stop(final_write=True)


# The spawn recipe of a server process: it hides every card from the
# child before torch is imported, so the server never creates a CUDA
# context beside the trainer's.  Use
#   subprocess.Popen([sys.executable, "-c", SERVER_BOOT, *args])
SERVER_BOOT = ("import os, sys; "
               "os.environ['CUDA_VISIBLE_DEVICES'] = ''; "
               "from paddle_tpu_torch.distributed.ps.service import _main; "
               "sys.exit(_main())")


def _main():
    ap = argparse.ArgumentParser(description="paddle_tpu_torch PS shard")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--table", action="append", required=True,
                    help="name:rows:dim[:optimizer[:lr]]")
    ap.add_argument("--n-workers", type=int, default=None,
                    help="shut down after this many workers say bye")
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0)
    a = ap.parse_args()
    serve(a.port, a.table, a.host, a.n_workers, a.heartbeat_timeout)


if __name__ == "__main__":
    _main()
