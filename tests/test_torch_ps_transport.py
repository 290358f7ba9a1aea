"""The PS transport's negotiated wire, push dedup, counters and
PSTrainStep's pipeline over a remote table, in the port, mirroring
tests/test_ps_transport.py on the CPU: the hello handshake and an old
server's f32 link, the (worker, seq) window, client and server byte
counters, the prefetch pipeline's push_pull coalescing with its epoch
fence, stale-epoch discard, push replay under injected ``ps.rpc`` and
``ps.pipeline`` faults, the RPC spans' causal links, and the bf16 wire's
losses against the reference's.

Tolerances: the port's own runs bitwise (under
``torch.use_deterministic_algorithms``; the batches' ids are pairwise
disjoint, so a prefetch's staleness cannot show); the bf16 wire's losses
and table within 1e-5 of the largest of the reference's on the same
wire (both round to bf16 alike); a bf16 pull's bytes under 0.55 of
f32's.  Tables of 256 rows, batches of 8."""
import json
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import ps as jps
from paddle_tpu.distributed.ps import service as jsvc
from paddle_tpu.models import WideDeepHost as JWideDeepHost
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps.service import (PsClient, PsServer,
                                                     RemoteEmbeddingTable)
from paddle_tpu_torch.framework import chaos, monitor, observability
from paddle_tpu_torch.models import WideDeepHost, load_named_params
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam

REL = 1e-5
V, E, FIELDS, DD, B, STEPS = 256, 8, 4, 3, 8, 6


@pytest.fixture(autouse=True)
def _fresh():
    chaos.reset(0)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)
    chaos.reset(0)


def _server(table=None, **kw):
    return PsServer({"emb": table or ps.HostEmbeddingTable(
        64, 8, optimizer="sgd", learning_rate=1.0)}, port=0, **kw).start()


def _ep(srv):
    return f"127.0.0.1:{srv.port}"


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# -- wire negotiation --------------------------------------------------------
def test_hello_handshake_reply():
    srv = _server()
    try:
        c = PsClient([_ep(srv)], wire_dtype="bf16")
        reply, _ = c._conns[0].rpc({"op": "hello", "wire": "bf16"})
        assert reply["wire"] == "bf16" and "time" in reply
        assert reply["wire_dtypes"] == ["f32", "bf16", "int8", "int4"]
        assert c._push_wire(0) == "bf16"
        c.bye()
    finally:
        srv.shutdown()


def test_old_server_degrades_push_to_f32(monkeypatch):
    """A server that does not know hello (nor push_pull) pins the push
    link to f32, and the push lands exactly."""
    srv = _server()
    orig = srv._dispatch

    def old_dispatch(header, bufs):
        if header.get("op") in ("hello", "push_pull"):
            return {"ok": False, "error": f"unknown op {header['op']!r}"}, []
        return orig(header, bufs)

    monkeypatch.setattr(srv, "_dispatch", old_dispatch)
    try:
        c = PsClient([_ep(srv)], wire_dtype="bf16")
        assert c._push_wire(0) == "f32"
        ids = np.arange(4)
        before = srv.tables["emb"]._table[ids].copy()
        g = np.full((4, 8), 0.3, np.float32)       # not exact in bf16
        c.push("emb", ids, g)
        assert np.array_equal(srv.tables["emb"]._table[ids], before - g)
        c.bye()
    finally:
        srv.shutdown()


def test_pull_decodes_the_reply_declared_wire(monkeypatch):
    """A server that ignores the asked wire and replies raw f32 with no
    "wire" key is decoded as f32."""
    t = ps.HostEmbeddingTable(16, 4, optimizer="sgd")
    srv = _server(t)
    orig = srv._dispatch

    def old_dispatch(header, bufs):
        if header.get("op") == "pull":
            return {"ok": True}, [t.pull(bufs[0].astype(np.int64))]
        return orig(header, bufs)

    monkeypatch.setattr(srv, "_dispatch", old_dispatch)
    try:
        c = PsClient([_ep(srv)], wire_dtype="bf16")
        assert np.array_equal(c.pull("emb", np.arange(6)), t._table[:6])
        c.bye()
    finally:
        srv.shutdown()


# -- push dedup --------------------------------------------------------------
def _sgd_server():
    t = ps.HostEmbeddingTable(16, 4, optimizer="sgd", learning_rate=1.0)
    return t, _server(t)


def test_replayed_stamp_applies_once():
    t, srv = _sgd_server()
    try:
        before = t._table.copy()
        header = {"op": "push", "table": "emb", "wire": "f32",
                  "worker": "w0", "seq": 7}
        bufs = [np.array([3]), np.ones((1, 4), np.float32)]
        r1, _ = srv._dispatch(dict(header), bufs)
        r2, _ = srv._dispatch(dict(header), bufs)
        assert r1["dup"] is False and r2["dup"] is True
        assert np.array_equal(t._table[3], before[3] - 1.0)
    finally:
        srv.shutdown()


def test_push_pull_retry_dedups_the_push_and_serves_the_pull():
    t, srv = _sgd_server()
    try:
        before = t._table.copy()
        header = {"op": "push_pull", "table": "emb", "wire": "f32",
                  "worker": "w0", "seq": 9, "n_push_bufs": 1}
        bufs = [np.array([2]), np.ones((1, 4), np.float32),
                np.array([2, 5])]
        r1, rows1 = srv._dispatch(dict(header), bufs)
        r2, rows2 = srv._dispatch(dict(header), bufs)
        assert r1["dup"] is False and r2["dup"] is True
        assert np.array_equal(t._table[2], before[2] - 1.0)
        assert np.array_equal(rows1[0], rows2[0])
    finally:
        srv.shutdown()


def test_distinct_pushes_and_a_new_incarnation_apply():
    """Two pushes of one client take two stamps; a client rebuilt under
    the same worker id starts its stamps again without colliding."""
    t, srv = _sgd_server()
    try:
        before = t._table.copy()
        for _ in range(2):
            c = PsClient([_ep(srv)], worker_id="rank-0", wire_dtype="f32")
            c.push("emb", np.array([1]), np.ones((1, 4), np.float32))
            c.push("emb", np.array([1]), np.ones((1, 4), np.float32))
            c.bye()
        want = before[1]
        for _ in range(4):
            want = want - np.float32(1.0)
        assert np.array_equal(t._table[1], want)
    finally:
        srv.shutdown()


def test_failed_apply_releases_its_stamp():
    t, srv = _sgd_server()
    try:
        before = t._table.copy()
        bufs = [np.array([4]), np.ones((1, 4), np.float32)]
        with pytest.raises(KeyError):
            srv._dispatch({"op": "push", "table": "nope", "wire": "f32",
                           "worker": "w0", "seq": 3}, bufs)
        r, _ = srv._dispatch({"op": "push", "table": "emb", "wire": "f32",
                              "worker": "w0", "seq": 3}, bufs)
        assert r["dup"] is False
        assert np.array_equal(t._table[4], before[4] - 1.0)
        # a retry racing a slow apply finds the stamp claimed
        assert srv._reserve_push({"worker": "w9", "seq": 5}) is True
        assert srv._reserve_push({"worker": "w9", "seq": 5}) is False
        assert srv._is_dup_push({"worker": "w9", "seq": 5})
        srv._unreserve_push({"worker": "w9", "seq": 5})
        assert srv._reserve_push({"worker": "w9", "seq": 5}) is True
    finally:
        srv.shutdown()


def test_seq_window_and_worker_count_are_bounded():
    srv = _server()
    try:
        for s in range(srv.PUSH_SEQ_WINDOW + 10):
            srv._reserve_push({"worker": "w", "seq": s})
        assert len(srv._push_seen["w"]) == srv.PUSH_SEQ_WINDOW
        for w in range(srv.PUSH_SEQ_WORKERS + 10):
            srv._reserve_push({"worker": f"worker-{w}", "seq": 0})
        assert len(srv._push_seen) == srv.PUSH_SEQ_WORKERS
        assert "worker-0" not in srv._push_seen
    finally:
        srv.shutdown()


def test_pipeline_replay_reuses_its_seq():
    """A coalesced push that landed but whose reply was lost: the replay
    re-sends the original stamp and the server drops it."""
    t = ps.HostEmbeddingTable(256, 9, optimizer="sgd", learning_rate=1.0)
    srv = _server(t)
    try:
        c = PsClient([_ep(srv)], wire_dtype="f32")
        step = _mk_step(RemoteEmbeddingTable(c, "emb", 9))
        before = t._table.copy()
        ids_p, g_p = np.array([3]), np.ones((1, 9), np.float32)
        seq = c._next_seq()
        c.push("emb", ids_p, g_p, seq=seq)
        fut = Future()
        fut.set_exception(RuntimeError("reply lost"))
        assert step._settle_inflight({
            "key": ids_p, "epoch": None, "span": None,
            "push": (ids_p, g_p, seq, []), "future": fut}) is None
        assert np.array_equal(t._table[3], before[3] - 1.0)
        c.bye()
    finally:
        srv.shutdown()


# -- the table's width and the counters --------------------------------------
def test_empty_pull_uses_the_cached_width():
    srv = _server(ps.HostEmbeddingTable(8, 5))
    try:
        c = PsClient([_ep(srv)], wire_dtype="f32")
        for _ in range(3):
            assert c.pull("emb", np.zeros((0,), np.int64)).shape == (0, 5)
        assert c.transport_stats()["per_op"]["stat"]["rpcs"] == 1
        c.pull("emb", np.array([1, 2]))
        c.pull("emb", np.zeros((0,), np.int64))
        assert c.transport_stats()["per_op"]["stat"]["rpcs"] == 1
        c.bye()
    finally:
        srv.shutdown()


def test_client_and_server_counters_agree():
    """What the client sent the server received and the other way round;
    the process statistics and histograms take the reference's names."""
    srv = _server()
    try:
        n0 = monitor.get_stat("ps_client_rpcs")
        c = PsClient([_ep(srv)], wire_dtype="bf16")
        c.pull("emb", np.arange(8))
        c.push("emb", np.arange(8), np.ones((8, 8), np.float32))
        snap = c.transport_stats()
        assert snap["rpcs"] == 3 and monitor.get_stat(
            "ps_client_rpcs") - n0 == 3              # hello, pull, push
        assert snap["per_op"]["pull"]["rpcs"] == 1
        assert snap["latency_ms"]["pull"]["count"] == 1
        s = srv.transport.snapshot()
        assert s["bytes_recv"] == snap["bytes_sent"]
        assert s["bytes_sent"] == snap["bytes_recv"]
        hists = monitor.all_histograms()
        assert {"ps_client_rpc_ms_pull", "ps_server_rpc_ms_pull"} <= set(
            hists)
        stat = c.stat()
        assert stat["transport"]["per_op"]["pull"]["rpcs"] == 1
        assert stat["client_transport"]["per_op"]["pull"]["rpcs"] == 1
        assert stat["table_stats"]["emb"]["rows_pulled"] == 8
        c.bye()
    finally:
        srv.shutdown()


def test_bf16_wire_under_0p55_of_f32_bytes():
    srv = _server(ps.HostEmbeddingTable(4096, 64))
    try:
        def bytes_for(wire):
            c = PsClient([_ep(srv)], wire_dtype=wire)
            s0 = c.transport_stats()["bytes_recv"]
            c.pull("emb", np.arange(2048))
            n = c.transport_stats()["bytes_recv"] - s0
            c.bye()
            return n
        assert bytes_for("bf16") / bytes_for("f32") < 0.55
    finally:
        srv.shutdown()


# -- PSTrainStep over a remote table -----------------------------------------
def _loss(m, rows, x, y):
    return F.binary_cross_entropy_with_logits(m(rows, x), y).mean()


def _mk_step(table, prefetch_depth=None, init=None):
    emb = ps.DistributedEmbedding(V, E + 1, mode="sync", table=table,
                                  device="cpu")
    torch.manual_seed(0)
    model = WideDeepHost(embedding_dim=E, num_fields=FIELDS, dense_dim=DD,
                         hidden=(16,), device="cpu")
    if init is not None:
        load_named_params(model, init)
    kw = {} if prefetch_depth is None else {"prefetch_depth": prefetch_depth}
    return ps.PSTrainStep(model, _loss, Adam(learning_rate=1e-2), emb,
                          transfer_dtype="float32", device="cpu", **kw)


def _disjoint_batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    per = B * FIELDS
    perm = rng.permutation(V)[:n * per]
    return [perm[i * per:(i + 1) * per].reshape(B, FIELDS).astype(np.int64)
            for i in range(n)]


def _data():
    rng = np.random.default_rng(3)
    return (_disjoint_batches(),
            rng.standard_normal((B, DD)).astype(np.float32),
            rng.integers(0, 2, (B, 1)).astype(np.float32))


def _run(step, batches, x, y, announce=True):
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    if announce:
        step.prefetch(batches[0])
    for n, ids in enumerate(batches):
        if announce and n + 1 < len(batches):
            step.prefetch(batches[n + 1])
        losses.append(float(step(ids, x, y)))
    step.flush()
    return losses


def _remote(prefetch_depth=None, wire="f32"):
    t = ps.HostEmbeddingTable(V, E + 1, optimizer="sgd", learning_rate=0.05,
                              seed=0)
    srv = _server(t)
    c = PsClient([_ep(srv)], wire_dtype=wire, backoff_base=0.01)
    return t, srv, c, _mk_step(RemoteEmbeddingTable(c, "emb", E + 1),
                               prefetch_depth)


def _clean_run(prefetch_depth):
    batches, x, y = _data()
    t, srv, c, step = _remote(prefetch_depth)
    try:
        losses = _run(step, batches, x, y, announce=prefetch_depth != 0)
        c.bye()
    finally:
        srv.shutdown()
    return losses, t._table.copy(), c.transport_stats()["per_op"]


def test_pipelined_equals_unpipelined_and_coalesces():
    """On disjoint batches the prefetched run's losses and table are
    bitwise the unpipelined run's, and its steady state rides push_pull
    (one RPC a step)."""
    ref, ref_t, ref_ops = _clean_run(0)
    got, got_t, ops = _clean_run(1)
    assert got == ref and np.array_equal(got_t, ref_t)
    assert ops["push_pull"]["rpcs"] >= STEPS - 2
    assert "push_pull" not in ref_ops


@pytest.mark.parametrize("point,spec", [
    ("ps.pipeline", dict(mode="error", every=2)),
    ("ps.pipeline", dict(mode="latency", latency=0.02, every=2)),
    ("ps.rpc", dict(mode="error", every=5)),
], ids=["pipeline-error", "pipeline-latency", "rpc-error"])
def test_deterministic_under_injected_faults(point, spec):
    """Injected prefetch and transport faults lose no push and change no
    bit: the sync re-pull, the stamped replay and the RPC retry reconverge
    on the clean run."""
    ref, ref_t, _ = _clean_run(1)
    batches, x, y = _data()
    t, srv, c, step = _remote(1)
    try:
        with chaos.inject(point, **spec):
            got = _run(step, batches, x, y)
            assert chaos.stats()[point]["trips"] >= 1
        assert got == ref and np.array_equal(t._table, ref_t)
        c.bye()
    finally:
        srv.shutdown()


def test_reform_mid_prefetch_discards_the_stale_rows():
    """A re-form (epoch bump and server fence) between a prefetch's issue
    and its consume: the rows are discarded ("stale_epoch"), the step
    pulls again under the new epoch, and training goes on."""
    batches, x, y = _data()
    t, srv, c, step = _remote(1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    try:
        c.set_epoch(1, fence_servers=True)
        step.prefetch(batches[0])
        step.prefetch(batches[1])
        m0 = monitor.get_stat("ps_prefetch_misses_total")
        losses = [float(step(batches[0], tx, ty))]
        assert step._inflight
        step._inflight[0]["future"].result()
        c.set_epoch(2, fence_servers=True)
        for n in range(1, len(batches)):
            if n + 1 < len(batches):
                step.prefetch(batches[n + 1])
            losses.append(float(step(batches[n], tx, ty)))
        step.flush()
        assert np.isfinite(losses).all()
        assert monitor.get_stat("ps_prefetch_misses_total") - m0 == 1
        assert srv.epoch == 2
        ids_last = np.unique(batches[-1])
        init = ps.HostEmbeddingTable(V, E + 1, optimizer="sgd",
                                     learning_rate=0.05, seed=0)
        assert not np.allclose(t._table[ids_last], init._table[ids_last])
        c.bye()
    finally:
        srv.shutdown()


def test_stale_epoch_coalesced_push_is_dropped():
    """A coalesced push stamped before a re-form this client has not
    adopted is rejected by the fence; the pipeline drops it without
    raising and without a replay."""
    batches, x, y = _data()
    t, srv, c, step = _remote(1)
    try:
        c.set_epoch(1, fence_servers=True)
        ref = t._table.copy()
        step._pending_push.append((np.array([7]),
                                   np.ones((1, E + 1), np.float32), None))
        step.prefetch(batches[0])
        other = PsClient([_ep(srv)], wire_dtype="f32")
        other.set_epoch(2, fence_servers=True)
        step._issue_prefetch()
        assert step._consume_prefetch(batches[0]) is None
        assert np.array_equal(t._table, ref)
        c.bye()
        other.bye()
    finally:
        srv.shutdown()


def test_prefetch_depth_0_is_a_no_op():
    batches, x, y = _data()
    t, srv, c, step = _remote(0)
    try:
        step.prefetch(batches[0])
        assert not step._announced
        assert np.isfinite(float(step(batches[0], torch.from_numpy(x),
                                      torch.from_numpy(y))))
        step.flush()
        assert "push_pull" not in c.transport_stats()["per_op"]
        c.bye()
    finally:
        srv.shutdown()


def test_rpc_spans_carry_the_deferred_push_links(tmp_path):
    """Traced: each logical RPC is a ps.<op> span with a ps.rpc child an
    attempt, the server re-opens it as ps.server.<op>, and every coalesced
    push_pull links ("deferred_push") to the train.step that produced its
    gradient."""
    batches, x, y = _data()
    t, srv, c, step = _remote(1)
    observability.tracer.enable(str(tmp_path), label="ps")
    try:
        _run(step, batches[:4], x, y)
        c.bye()
    finally:
        observability.tracer.disable()
        srv.shutdown()
    spans = [json.loads(line) for line in open(tmp_path / "trace_ps.jsonl")
             if '"span"' in line]
    spans = [s for s in spans if s.get("kind") == "span"]
    by_id = {s["span"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names.count("train.step") == 4
    pp = [s for s in spans if s["name"] == "ps.push_pull"]
    assert len(pp) >= 2
    for s in pp:
        kinds = {ln["kind"] for ln in s.get("links", ())}
        assert kinds == {"deferred_push"}
        assert all(by_id[ln["span"]]["name"] == "train.step"
                   for ln in s["links"])
    rpc = [s for s in spans if s["name"] == "ps.rpc"]
    assert all(by_id[s["parent"]]["name"].startswith("ps.") for s in rpc)
    served = [s for s in spans if s["name"] == "ps.server.push_pull"]
    assert {s["parent"] for s in served} <= {s["span"] for s in rpc}


def test_bf16_wire_losses_match_the_reference():
    """PSTrainStep over a remote table on the default bf16 wire, prefetched:
    the losses and the server's table within 1e-5 of the largest of the
    reference's run over its own server, and the loss falls."""
    batches, x, y = _data()

    paddle.seed(0)
    jmodel = JWideDeepHost(embedding_dim=E, num_fields=FIELDS, dense_dim=DD,
                           hidden=(16,))
    init = {n: np.asarray(p._data) for n, p in jmodel.named_parameters()}
    jt = jps.HostEmbeddingTable(V, E + 1, optimizer="sgd",
                                learning_rate=0.05, seed=0)
    jsrv = jsvc.PsServer({"emb": jt}, port=0).start()
    try:
        jc = jsvc.PsClient([_ep(jsrv)], wire_dtype="bf16")
        jemb = jps.DistributedEmbedding(
            V, E + 1, mode="sync", table=jsvc.RemoteEmbeddingTable(
                jc, "emb", E + 1))

        def jloss(m, rows, xb, yb):
            return JF.binary_cross_entropy_with_logits(m(rows, xb),
                                                       yb).mean()
        jstep = jps.PSTrainStep(jmodel, jloss, jopt.Adam(
            learning_rate=1e-2, parameters=jmodel.parameters()), jemb,
            transfer_dtype="float32")
        jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
        want = []
        jstep.prefetch(batches[0])
        for n, ids in enumerate(batches):
            if n + 1 < len(batches):
                jstep.prefetch(batches[n + 1])
            want.append(float(jstep(ids, jx, jy)))
        jstep.flush()
        jc.bye()
    finally:
        jsrv.shutdown()

    t = ps.HostEmbeddingTable(V, E + 1, optimizer="sgd", learning_rate=0.05,
                              seed=0)
    srv = _server(t)
    try:
        c = PsClient([_ep(srv)], wire_dtype="bf16")
        got = _run(_mk_step(RemoteEmbeddingTable(c, "emb", E + 1),
                            init=init), batches, x, y)
        c.bye()
    finally:
        srv.shutdown()
    _close(got, want)
    _close(t._table, jt._table)
    assert got[-1] < got[0]
