"""The port's cluster collector (paddle_tpu_torch/framework/collector.py)
against the reference's on the CPU.

The wire frames are the reference's byte for byte (a header written by
each package's ``_send`` over a socket pair reads the same bytes, and
each package's ``_recv`` reads the other's); a port client pushes to a
reference server and a reference client to a port server.  Fed the same
report sequence (three workers' step times drawn from a numpy seed, one
of them slow, plus table telemetry and incident notices), the two
servers give the same straggler scores and flags, the same view (but for
its timestamps) and the same cluster record.  A ``MetricsReporter`` in
push mode lands the port process in a collector's view, its incident
notice included, and the collector's ``monitor.describe`` texts make the
port's Prometheus text the reference's.
"""
import json
import socket
import time

import numpy as np
import pytest

from paddle_tpu.framework import collector as jcol
from paddle_tpu_torch.framework import collector as tcol

from torch_planes_common import PORT, REF, clean_planes


def _frame(mod, header):
    a, b = socket.socketpair()
    try:
        n = mod._send(a, header)
        data = b.recv(1 << 16)
        assert len(data) == n
        return data
    finally:
        a.close()
        b.close()


def test_frames_are_the_references_byte_for_byte():
    header = {"op": "report", "worker": "w0", "role": "trainer", "seq": 3,
              "ident": "w0~ab12", "payload": {"stats": {"x": 1.5},
                                              "flight": [{"seq": 1}]}}
    assert _frame(tcol, header) == _frame(jcol, header)
    for send, recv in ((tcol, jcol), (jcol, tcol)):
        a, b = socket.socketpair()
        try:
            send._send(a, header)
            assert recv._recv(b) == json.loads(json.dumps(header))
        finally:
            a.close()
            b.close()


def _wait(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("client_mod,server_mod", [(tcol, jcol),
                                                   (jcol, tcol)])
def test_clients_and_servers_cross(client_mod, server_mod):
    srv = server_mod.CollectorServer().start()
    try:
        cli = client_mod.CollectorClient(srv.endpoint, worker="x",
                                         role="trainer", timeout=1.0)
        st = {"count": 0, "sum": 0.0}
        assert cli.push(_step_payload(st, 2.0))
        assert _wait(lambda: cli.sent == 1)
        view = server_mod.request(srv.endpoint, {"op": "view"})["view"]
        assert view["workers"]["x"]["steps_total"] == 1
        cli.stop()
    finally:
        srv.shutdown()


def _step_payload(state, ms):
    state["count"] += 1
    state["sum"] += ms
    return {"stats": {"train_steps_total": state["count"]},
            "hists": {"train_step_ms": {"count": state["count"],
                                        "sum": state["sum"], "p50": ms,
                                        "p99": ms, "mean": ms, "max": ms}}}


def _reports(seed=0, rounds=8):
    """Three workers' reports (w2 slow), a PS shard's table telemetry
    and an incident notice, from a numpy seed."""
    rng = np.random.default_rng(seed)
    states = {w: {"count": 0, "sum": 0.0} for w in ("w0", "w1", "w2")}
    out = []
    for i in range(rounds):
        for w in states:
            ms = float(rng.uniform(8, 12) * (5.0 if w == "w2" else 1.0))
            p = _step_payload(states[w], ms)
            p["flight"] = [{"seq": i + 1, "ts": 100.0 + i, "kind": "k",
                            "severity": "info", "attrs": {}}]
            if w == "w1" and i == 3:
                p["incidents"] = [{"id": 1, "kind": "train.nan_skip",
                                   "step": 3, "bundle": "/b",
                                   "worker": "w1"}]
            out.append({"worker": w, "role": "trainer", "seq": i + 1,
                        "ident": f"{w}~0", "payload": p})
        out.append({"worker": "s0", "role": "server", "seq": i + 1,
                    "ident": "s0~0", "payload": {
                        "stats": {}, "hists": {},
                        "tables": {"emb": {"pulls": 10 * (i + 1),
                                           "pushes": 5 * (i + 1),
                                           "rows_pulled": 40 * (i + 1),
                                           "hot_rows": [[7, 3 + i],
                                                        [2, i]]}}}})
    return out


def _strip_times(view):
    view = json.loads(json.dumps(view))
    for k in ("ts", "time", "endpoint"):
        view.pop(k, None)
    for w in view.get("workers", {}).values():
        for k in [k for k in w if k.endswith("_ago") or k in (
                "last_seen", "age_s")]:
            w.pop(k)
    return view


def test_same_reports_same_scores_view_and_record(tmp_path):
    clock = lambda: 1000.0                                    # noqa: E731
    with clean_planes():
        views, reps, recs = [], [], []
        for mod in (jcol, tcol):
            srv = mod.CollectorServer(straggler_ratio=2.0, window=4,
                                      clock=clock)
            for h in _reports():
                srv._handle_report(dict(h))
            reps.append(srv.straggler_report())
            views.append(_strip_times(srv.view()))
            rec, _ = srv.capture_record(label="cluster")
            recs.append(rec)
            srv.shutdown()
    assert reps[1] == reps[0]
    assert reps[1]["stragglers"] == ["w2"]
    assert views[1] == views[0]
    for r in recs:
        for k in ("ts", "run_id", "meta"):
            r.pop(k, None)
    assert recs[1]["summary"] == recs[0]["summary"]
    assert recs[1].get("cluster") == recs[0].get("cluster")


def test_push_mode_reporter_carries_the_incident_notice():
    from paddle_tpu_torch.framework import incident
    srv = tcol.CollectorServer().start()
    try:
        with clean_planes():
            PORT.monitor.observe("train_step_ms", 5.0)
            incident.recorder.notices.append(
                {"id": 9, "kind": "train.nan_skip", "step": 2,
                 "bundle": "/x", "worker": "me"})
            rep = PORT.obs.MetricsReporter(None, interval=60.0,
                                           collector=srv.endpoint,
                                           worker="me", role="trainer")
            rep.start()
            rep.stop()
            assert _wait(lambda: rep.collector.sent >= 2)
            view = srv.view()
            assert view["workers"]["me"]["role"] == "trainer"
            assert any(n["id"] == 9 for n in view.get("incidents", []))
    finally:
        incident.reset()
        srv.shutdown()


def test_prometheus_text_with_the_collectors_descriptions():
    """Both collectors imported: the same metrics export the same
    Prometheus text, HELP lines included."""
    with clean_planes():
        for pkg in (PORT, REF):
            pkg.monitor.stat_set("cluster_straggler_score", 1.5)
            pkg.monitor.stat_set("ps_server_table_pulls", 3)
            pkg.monitor.stat_add("cluster_step_anomalies_total", 2)
        assert PORT.monitor.export_prometheus() == \
            REF.monitor.export_prometheus()
