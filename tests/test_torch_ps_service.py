"""The parameter server's TCP transport of the port
(paddle_tpu_torch/distributed/ps/service.py) against the reference's, on
the CPU: the wire frames, each package's client against the other's
server, id % n routing, the admin ops, heartbeat, training through a
remote table, fleet's PS lifecycle and a server in its own process.

Tolerances: frames byte for byte; pulled rows, tables after the same
pushes and the port's remote-table training bitwise (the port runs
under ``torch.use_deterministic_algorithms``); the port's losses against
the reference's within 1e-5 of the largest (the dense net's f32 math in
two libraries; the losses fall to 1e-8, where f32 rounding alone is
1e-4 of their own size).  Tables of at most 50 rows, so the file runs in seconds."""
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import ps as jps
from paddle_tpu.distributed.ps import device_table as jdt
from paddle_tpu.distributed.ps import service as jsvc
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed import wire
from paddle_tpu_torch.distributed.ps import service as svc
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import SGD

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _close(got, want, rel=REL):
    """max |got - want| within ``rel`` of max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _serve(mod, tables, **kw):
    return mod.PsServer(tables, port=0, **kw).start()


def _ep(srv):
    return f"127.0.0.1:{srv.port}"


# -- the wire ----------------------------------------------------------------
def _rows(n=6, d=5):
    return np.random.default_rng(0).standard_normal((n, d)).astype(
        np.float32) * 3


@pytest.mark.parametrize("what", ["f32", "bf16", "int8", "int4", "int64"])
def test_frames_are_the_references_byte_for_byte(what):
    """A header with ids and encoded rows frames to the reference's bytes,
    and the reference's frame reads back as the port's buffers."""
    header = {"op": "push", "table": "emb", "lr": None, "wire": what,
              "worker": "w~00", "seq": 3}
    if what == "int64":
        want_bufs = got_bufs = [np.arange(7, dtype=np.int64) * 11]
    else:
        want_bufs = jdt.quantize_rows(_rows(), what)
        got_bufs = wire.quantize_rows(_rows(), what)
    want = jsvc._frame_msg(header, [np.arange(6)] + want_bufs)
    got = svc._frame_msg(header, [np.arange(6)] + got_bufs)
    assert got == want
    a, b = socket.socketpair()
    try:
        a.sendall(want)
        hdr, bufs, n = svc._recv_msg(b)
    finally:
        a.close()
        b.close()
    assert hdr == header and n == len(want)
    for x, y in zip(bufs, [np.arange(6)] + got_bufs):
        x = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) \
            else x
        y = y.view(torch.int16).numpy() if isinstance(y, torch.Tensor) \
            else y
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "ref"), ("ref", "port")],
                         ids=["port_client", "ref_client"])
def test_cross_package_client_and_server(client_pkg, server_pkg,
                                         wire_dtype):
    """Each package's client against the other's server over two shards:
    pulls, pushes, a coalesced push_pull and an adagrad table, the tables
    and rows bitwise a same-package run's (bf16 rounds alike in both)."""
    mods = {"port": (svc, ps), "ref": (jsvc, jps)}
    rng = np.random.default_rng(1)
    calls = [(rng.integers(0, 40, 12), rng.standard_normal(
        (12, 6)).astype(np.float32)) for _ in range(3)]

    def run(cpkg, spkg):
        smod, tmod = mods[spkg]
        tables = [tmod.HostEmbeddingTable(40, 6, seed=s) for s in (1, 2)]
        srvs = [_serve(smod, {"emb": t}) for t in tables]
        try:
            c = mods[cpkg][0].PsClient([_ep(s) for s in srvs],
                                       wire_dtype=wire_dtype)
            pulled = [c.pull("emb", np.arange(40))]
            for ids, g in calls:
                c.push("emb", ids, g)
                pulled.append(c.push_pull("emb", ids[:4], g[:4], ids))
            c.bye()
        finally:
            for s in srvs:
                s.shutdown()
        return pulled, [t._table.copy() for t in tables], [
            t._g2.copy() for t in tables]

    got = run(client_pkg, server_pkg)
    want = run(server_pkg, server_pkg)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert np.array_equal(x, y)


# -- routing and the admin ops -----------------------------------------------
def _both(fn):
    """fn(service module, table module) in the port and the reference."""
    return fn(svc, ps), fn(jsvc, jps)


def test_mod_sharding_over_two_servers():
    """Ids route to server id % 2, each table sees only its own, pulls
    reassemble in request order: rows and tables as the reference's."""
    def run(smod, tmod):
        t0 = tmod.HostEmbeddingTable(10, 3, optimizer="sgd", seed=1)
        t1 = tmod.HostEmbeddingTable(10, 3, optimizer="sgd", seed=2)
        s0, s1 = _serve(smod, {"emb": t0}), _serve(smod, {"emb": t1})
        try:
            c = smod.PsClient([_ep(s0), _ep(s1)], wire_dtype="f32")
            ids = np.array([0, 1, 2, 3, 7])
            rows = c.pull("emb", ids)
            for i, idx in enumerate(ids):
                assert np.array_equal(rows[i], (t1 if idx % 2 else t0)
                                      ._table[idx])
            b0 = t0._table.copy()
            c.push("emb", ids, np.ones((5, 3), np.float32), lr=1.0)
            assert np.array_equal(t0._table[[1, 3, 7]], b0[[1, 3, 7]])
            c.bye()
        finally:
            s0.shutdown()
            s1.shutdown()
        return rows, t0._table.copy(), t1._table.copy()
    got, want = _both(run)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)


def test_empty_pull_bad_op_and_state_round_trip():
    """The empty pull's (0, dim), an unknown table's error naming the op,
    the state and load_state ops: as the reference's."""
    def run(smod, tmod):
        t = tmod.HostEmbeddingTable(6, 2)
        srv = _serve(smod, {"emb": t})
        try:
            c = smod.PsClient([_ep(srv)], wire_dtype="f32")
            empty = c.pull("emb", np.zeros((0,), np.int64)).shape
            with pytest.raises(RuntimeError, match="pull"):
                c.pull("nope", np.array([1]))
            c.push("emb", np.arange(6), np.ones((6, 2), np.float32))
            reply, bufs = c._conns[0].rpc({"op": "state", "table": "emb"})
            t2 = tmod.HostEmbeddingTable(6, 2, seed=9)
            srv.tables["emb2"] = t2
            c._conns[0].rpc({"op": "load_state", "table": "emb2",
                             "optimizer": "adagrad", "has_g2": True}, bufs)
            with pytest.raises(RuntimeError, match="unknown op"):
                c._conns[0].rpc({"op": "nope"})
            c.bye()
        finally:
            srv.shutdown()
        return empty, reply["optimizer"], reply["has_g2"], t2._table, t2._g2
    got, want = _both(run)
    assert got[:3] == want[:3] == ((0, 2), "adagrad", True)
    assert np.array_equal(got[3], want[3]) and np.array_equal(got[4], want[4])


def test_heartbeat_dead_detection_and_stat():
    """A worker silent past the timeout is dead, a beat revives it (one
    flap), the monitor's thread reports it once; a server's stat sees a
    client's heartbeat, its tables, the wire dtypes, both ends' transport
    counters, the flight ring and the health snapshot."""
    for mod in (svc, jsvc):
        mon = mod.HeartBeatMonitor(timeout=0.1)
        mon.beat("w0")
        assert mon.dead_workers() == []
        time.sleep(0.15)
        assert mon.dead_workers() == ["w0"]
        mon.mark_dead("w0")
        mon.beat("w0")
        assert mon.dead_workers() == [] and mon.flap_count("w0") == 1
        died = []
        mon = mod.HeartBeatMonitor(timeout=0.05)
        mon.on_dead = died.append
        mon.start(interval=0.02)
        mon.beat("w1")
        time.sleep(0.2)
        mon.stop()
        assert died == ["w1"]

    def run(smod, tmod):
        srv = _serve(smod, {"emb": tmod.HostEmbeddingTable(4, 2)})
        try:
            c = smod.PsClient([_ep(srv)], worker_id="trainer-7",
                              wire_dtype="f32")
            c.heartbeat()
            st = c.stat()
            c.bye()
        finally:
            srv.shutdown()
        return st
    got, want = _both(run)
    assert "trainer-7" in got["workers"] and got["dead"] == []
    assert got["tables"] == want["tables"] == {"emb": {"rows": 4, "dim": 2}}
    assert got["wire_dtypes"] == want["wire_dtypes"]
    assert set(got) == set(want)
    assert got["transport"]["per_op"]["heartbeat"]["rpcs"] == 1
    assert got["client_transport"]["per_op"]["heartbeat"]["rpcs"] == 1


# -- training through a remote table ----------------------------------------
def _train_eager(emb, head, opt, steps=15):
    ids = np.asarray([[1], [2], [3], [4]])
    target = torch.tensor([[1.0], [-1.0], [1.0], [-1.0]])
    losses = []
    for _ in range(steps):
        rows = emb(torch.from_numpy(ids))
        loss = ((head(rows.reshape(4, 4)) - target) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def test_remote_matches_local_training():
    """15 eager SGD steps of an embedding and a linear head: over a remote
    table (f32 wire) bitwise the local table's losses and rows, and
    within 1e-5 of the largest of the reference's remote run."""
    paddle.seed(0)
    jhead = jnn.Linear(4, 1)
    init = {n: np.asarray(p._data) for n, p in jhead.named_parameters()}

    def port_run(table):
        emb = ps.DistributedEmbedding(20, 4, optimizer="sgd",
                                      learning_rate=0.5, seed=0,
                                      table=table, device="cpu")
        head = load_named_params(Linear(4, 1, device="cpu"), init)
        return _train_eager(emb, head, SGD(learning_rate=0.5,
                                           parameters=head.parameters()))

    local_t = ps.HostEmbeddingTable(20, 4, "sgd", 0.5, seed=0)
    local = port_run(local_t)
    srv = _serve(svc, {"emb": ps.HostEmbeddingTable(20, 4, "sgd", 0.5,
                                                    seed=0)})
    try:
        c = svc.PsClient([_ep(srv)], wire_dtype="f32")
        remote = port_run(svc.RemoteEmbeddingTable(c, "emb", 4))
        c.bye()
        remote_t = srv.tables["emb"]._table
    finally:
        srv.shutdown()
    assert remote == local and np.array_equal(remote_t, local_t._table)

    jsrv = _serve(jsvc, {"emb": jps.HostEmbeddingTable(20, 4, "sgd", 0.5,
                                                       seed=0)})
    try:
        jc = jsvc.PsClient([_ep(jsrv)], wire_dtype="f32")
        jemb = jps.DistributedEmbedding(
            20, 4, table=jsvc.RemoteEmbeddingTable(jc, "emb", 4))
        want = []
        jo = jopt.SGD(learning_rate=0.5, parameters=jhead.parameters())
        ids = np.asarray([[1], [2], [3], [4]])
        target = paddle.to_tensor(np.asarray([[1.0], [-1.0], [1.0], [-1.0]],
                                             np.float32))
        for _ in range(15):
            rows = jemb(paddle.to_tensor(ids))
            loss = ((jhead(paddle.reshape(rows, [4, 4])) - target) ** 2
                    ).mean()
            loss.backward()
            jo.step()
            jo.clear_grad()
            want.append(float(loss))
        jc.bye()
    finally:
        jsrv.shutdown()
    _close(remote, want)
    assert remote[-1] < remote[0]


# -- fleet's PS lifecycle ----------------------------------------------------
def test_init_worker_and_stop_worker_from_the_environment(monkeypatch):
    """fleet.init() as a trainer, init_worker() on the shards of
    PADDLE_PSERVERS_IP_PORT_LIST (heartbeat started), ps_client()'s pull,
    stop_worker()'s bye; on one loopback rank, so no process group."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.parallel import LoopbackWorld
    t = ps.HostEmbeddingTable(8, 2)
    srv = _serve(svc, {"emb": t})
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", _ep(srv))
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")

    def fn(rank, mesh):
        fleet.init(device="cpu")
        with pytest.raises(RuntimeError, match="init_worker"):
            fleet.ps_client()
        fleet.init_worker()
        rows = fleet.ps_client().pull("emb", np.array([1, 2]))
        fleet.stop_worker()
        return rows
    try:
        rows = LoopbackWorld(1).run(fn)[0]
        # the default wire, FLAGS_ps_wire_dtype: bf16
        assert np.array_equal(rows, wire.dequantize_rows(
            wire.quantize_rows(t._table[[1, 2]], "bf16"), "bf16"))
        assert "trainer-0" in srv.monitor.workers()
        assert srv._bye_count == 1
    finally:
        srv.shutdown()


def test_server_exits_after_every_bye():
    srv = _serve(svc, {"emb": ps.HostEmbeddingTable(4, 2)}, n_workers=2)
    c1 = svc.PsClient([_ep(srv)], worker_id="w1")
    c2 = svc.PsClient([_ep(srv)], worker_id="w2")
    c1.bye()
    assert srv._tcp.fileno() != -1
    c2.bye()
    deadline = time.monotonic() + 5
    while srv._tcp.fileno() != -1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert srv._tcp.fileno() == -1


def test_server_role_joins_no_group_and_touches_no_card(monkeypatch):
    """TRAINING_ROLE=PSERVER: fleet.init() starts no process group and no
    CUDA context (with no card it does not raise, where a trainer's
    does), init_server builds the shard of its endpoint and run_server
    serves it until the one worker's bye."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import fleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVER_ID", "0")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "127.0.0.1:0")
    monkeypatch.delenv("PADDLE_TRAINERS_NUM", raising=False)
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS", raising=False)
    saved = dict(vars(fleet._GLOBAL))
    try:
        fleet.init()
        assert fleet.is_server() and not fleet.is_worker()
        assert not tdist.is_initialized()
        assert not torch.cuda.is_initialized()
        with pytest.raises(RuntimeError, match="init_server"):
            fleet.run_server()
        srv = fleet.init_server({"emb": (8, 2, "sgd", 1.0)})
        th = threading.Thread(target=fleet.run_server, daemon=True)
        th.start()
        c = svc.PsClient([_ep(srv)], wire_dtype="f32")
        assert np.array_equal(c.pull("emb", np.arange(8)),
                              srv.tables["emb"]._table)
        c.bye()
        th.join(timeout=5)
        assert not th.is_alive()
        assert not tdist.is_initialized()
    finally:
        vars(fleet._GLOBAL).clear()
        vars(fleet._GLOBAL).update(saved)


def test_serve_raises_on_a_collector_endpoint(monkeypatch):
    """serve() with a collector endpoint configured pushes the shard's
    telemetry there (the tables' request counts included), as the
    reference's server does, and stops its reporter when it stops."""
    from paddle_tpu_torch.framework.collector import CollectorServer
    col = CollectorServer().start()
    monkeypatch.setenv("PADDLE_COLLECTOR_ENDPOINT", col.endpoint)
    ready = threading.Event()
    addr = {}

    def announce(msg, **_):
        addr["ep"] = msg.split()[1]
        ready.set()
    th = threading.Thread(target=svc.serve, args=(0, ["emb:4:2"]),
                          kwargs={"n_workers": 1, "announce": announce},
                          daemon=True)
    th.start()
    try:
        assert ready.wait(10)
        client = svc.PsClient([addr["ep"]])
        client.pull("emb", np.array([1, 2]))
        client.bye()
        th.join(timeout=10)
        assert not th.is_alive()
        view = col.view()
        servers = [w for w, r in view["workers"].items()
                   if r.get("role") == "server"]
        assert servers, view["workers"]
    finally:
        col.shutdown()


def test_subprocess_server_through_server_boot():
    """A server process started by SERVER_BOOT (the card hidden before
    torch is imported) trains a sparse + dense model to the local table's
    losses, bitwise, and exits after the worker's bye."""
    assert svc.SERVER_BOOT.index("CUDA_VISIBLE_DEVICES") < \
        svc.SERVER_BOOT.index("paddle_tpu_torch")
    proc = subprocess.Popen(
        [sys.executable, "-c", svc.SERVER_BOOT, "--port", "0",
         "--table", "emb:50:4:sgd:0.5", "--n-workers", "1"],
        stdout=subprocess.PIPE, text=True, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("PS_READY"), line
        endpoint = line.split()[1]

        def run(table):
            torch.manual_seed(0)
            emb = ps.DistributedEmbedding(50, 4, optimizer="sgd",
                                          learning_rate=0.5, seed=0,
                                          table=table, device="cpu")
            head = Linear(10, 1, device="cpu")
            opt = SGD(learning_rate=0.2, parameters=head.parameters())
            rng = np.random.default_rng(5)
            ids = rng.integers(0, 50, size=(30, 8, 2))
            dense = rng.standard_normal((30, 8, 2)).astype(np.float32)
            w = rng.standard_normal((50,)).astype(np.float32)
            losses = []
            for s in range(30):
                rows = emb(torch.from_numpy(ids[s]))
                out = head(torch.cat([rows.reshape(8, 8),
                                      torch.from_numpy(dense[s])], 1))
                y = torch.from_numpy(w[ids[s]].sum(1, keepdims=True))
                loss = ((out - y) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss.detach()))
            return losses

        client = svc.PsClient([endpoint], worker_id="trainer-0",
                              wire_dtype="f32")
        remote = run(svc.RemoteEmbeddingTable(client, "emb", 4))
        local = run(None)
        assert remote == local
        assert remote[-1] < remote[0] * 0.5
        client.bye()
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
