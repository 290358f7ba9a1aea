"""``framework.observability`` of the port against the reference on the
CPU, and the spans and statistics the port's steps record:

- the same sequence of spans (nesting, an exception, a detached span, a
  causal link and a pending ``link_next``, a category, a clock offset)
  written by both packages' tracers: the reference's ``span_summary`` and
  ``tools/trace_merge.py`` (``merge``, ``validate_chrome_trace``,
  ``summarize``) read the port's file with the names, counts, error counts
  and categories of the reference's own, the records carry the
  reference's keys, and ``inject`` / ``extract`` round-trip;
- the flight ring (bounded, ordered, severity floor, kind filter) and its
  storm guard give the reference's readings for the same events;
- ``install_crash_handler``'s SIGTERM hook in a child process runs the
  ``on_sigterm`` callbacks, dumps the ring and still dies of SIGTERM;
- ``MetricsReporter`` writes the exposition text atomically, and its
  collector push mode drops against a dead collector;
- ``TrainStep`` records as the reference's: one ``train.step`` span a
  call with its step, one ``jit.compile``, ``train_steps_total``,
  ``train_step_ms``, the compile counters; at dp = 2 on ``LoopbackWorld``
  threads ``ShardedTrainStep`` and ``ShardedUpdateTrainStep`` record each
  step once (rank 0's thread speaks for the process);
- ``PSTrainStep``: a prefetch taken closes its span "ok", a discarded one
  (another batch's rows) with an error naming the reason."""
import copy
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_planes_common import BOTH, PORT, REF, REPO, clean_planes
from tools import trace_merge


def _spans(pkg, trace_dir, label):
    obs = pkg.obs
    tr = obs.Tracer(str(trace_dir), label=label)
    with tr.start_span("outer", attrs={"category": "compute"}) as outer:
        for i in range(3):
            with tr.start_span("inner", attrs={"i": i}):
                pass
        with pytest.raises(ValueError):
            with tr.start_span("boom"):
                raise ValueError("x")
        det = tr.start_span("prefetch", detached=True,
                            attrs={"category": "ps_wait"})
        tr.link_next(det.span_id, "prefetch")
        with tr.start_span("consume") as c:
            c.link(outer.span_id, "parent_link")
        det.end(status="error", reason="reordered")
        header = tr.inject({})
        ctx = obs.Tracer.extract(header)
        assert (ctx.trace_id, ctx.span_id) == (outer.trace_id,
                                               outer.span_id)
    tr.set_clock_offset(0.25)
    tr.disable()
    assert tr.start_span("dropped").span_id is None
    return os.path.join(str(trace_dir), f"trace_{label}.jsonl")


def _shape(rows):
    return sorted((r["name"], r["count"], r["errors"], r.get("category"))
                  for r in rows)


def test_reference_tools_read_the_port_span_file(tmp_path):
    paths = [_spans(pkg, tmp_path / name, name)
             for pkg, name in zip(BOTH, ("ref", "port"))]
    recs = []
    for p in paths:
        with open(p) as f:
            recs.append([json.loads(line) for line in f])
    for r_ref, r_port in zip(*recs):
        assert sorted(r_ref) == sorted(r_port)
        assert r_ref["kind"] == r_port["kind"]
        if r_ref["kind"] == "span":
            assert (r_ref["name"], r_ref["status"], r_ref.get("links") is
                    None) == (r_port["name"], r_port["status"],
                              r_port.get("links") is None)
    assert [r["clock_offset"] for r in recs[1] if r["kind"] == "process"] \
        == [0.0, 0.25]
    summaries = [_shape(REF.obs.span_summary(str(tmp_path / d)))
                 for d in ("ref", "port")]
    assert summaries[1] == summaries[0]
    assert ("inner", 3, 0, None) in summaries[1]
    assert ("prefetch", 1, 1, "ps_wait") in summaries[1]
    assert _shape(PORT.obs.span_summary(str(tmp_path / "port"))) == \
        summaries[0]
    merged = [trace_merge.merge([p]) for p in paths]
    for m in merged:
        assert trace_merge.validate_chrome_trace(m) > 0
    assert _shape(trace_merge.summarize(merged[1])) == \
        _shape(trace_merge.summarize(merged[0]))
    flows = [[e for e in m["traceEvents"] if e.get("ph") in ("s", "f")]
             for m in merged]
    assert len(flows[1]) == len(flows[0]) > 0


def _flight(pkg):
    fr = pkg.obs.FlightRecorder(capacity=4)
    for i in range(6):
        fr.record("step", severity=("debug", "info", "warn", "error",
                                    "bogus")[i % 5], i=i)
    ring = [(e["kind"], e["severity"], e["attrs"], e["seq"])
            for e in fr.recent(10)]
    warn = [e["attrs"]["i"] for e in fr.recent(10, min_severity="warn")]
    storm = pkg.obs.FlightRecorder(capacity=64)
    for _ in range(8):
        storm.record("ps.retry", op="pull")
    for i in range(3):
        storm.record("ps.retry", op="pull", attempt=i)
    return (ring, warn, fr.dropped, fr.last_seq(), [
        e["attrs"] for e in fr.since(4)], storm.suppressed,
        storm.kind_totals(), len(storm.recent(64, kind="ps.retry")))


def test_flight_ring_and_storm_guard():
    with clean_planes({"flight_storm_window": 60.0, "flight_storm_k": 3}):
        got = [_flight(pkg) for pkg in BOTH]
        supp = [pkg.monitor.get_stat("flight_suppressed_total")
                for pkg in BOTH]
    assert got[1] == got[0]
    assert got[1][5] == 5 and got[1][7] == 6 and supp == [5, 5]
    with pytest.raises(ValueError, match="unknown severity"):
        PORT.obs.flight.recent(5, min_severity="loud")


def test_sigterm_runs_callbacks_dumps_and_dies(tmp_path):
    code = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {REPO!r})
        from paddle_tpu_torch.framework import observability as obs
        obs.install_crash_handler(worker="w", flight_dir={str(tmp_path)!r})
        obs.on_sigterm("save", lambda: open(
            os.path.join({str(tmp_path)!r}, "saved"), "w").write("ok"))
        obs.on_sigterm("slow", lambda: __import__("time").sleep(5),
                       deadline=0.2)
        obs.flight.record("before.kill")
        os.kill(os.getpid(), signal.SIGTERM)
        import time
        time.sleep(10)
        """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == -15, res.stderr
    dump = json.loads((tmp_path / "flight_w.json").read_text())
    kinds = [e["kind"] for e in dump["events"]]
    assert kinds == ["before.kill", "sigterm.callback", "sigterm.callback",
                     "sigterm"]
    assert [e["attrs"]["status"] for e in dump["events"][1:3]] == [
        "ok", "timeout"]
    assert (tmp_path / "saved").read_text() == "ok"
    assert dump["worker"] == "w"


def test_crash_hook_and_metrics_reporter(tmp_path):
    prev = sys.excepthook
    try:
        hook = PORT.obs.install_crash_handler(
            worker="c", flight_dir=str(tmp_path), chain=False, sigterm=False)
        hook(RuntimeError, RuntimeError("bad"), None)
    finally:
        sys.excepthook = prev
    dump = json.loads((tmp_path / "flight_c.json").read_text())
    assert dump["events"][-1]["kind"] == "crash"
    with clean_planes():
        PORT.monitor.stat_add("train_steps_total", 2)
        path = tmp_path / "m" / "metrics.prom"
        rep = PORT.obs.MetricsReporter(str(path), interval=60.0).start()
        rep.stop()
        assert rep.writes == 2 and rep.collector is None
        assert path.read_text() == PORT.monitor.export_prometheus()
        assert not [p for p in os.listdir(path.parent) if ".tmp" in p]
    # push mode: a collector client is built, and a push to a dead
    # endpoint is a counted drop, never an error in the caller
    with clean_planes({"collector_timeout": 0.2}):
        rep = PORT.obs.MetricsReporter(str(path), interval=60.0,
                                       collector="127.0.0.1:1")
        assert rep.collector is not None
        rep.write_once()
        rep.stop()
        assert rep.pushes == 2 and rep.writes == 2
        assert PORT.monitor.get_stat("collector_dropped_total") >= 1


# -- the steps' spans and statistics -----------------------------------------
def _train(pkg_name, trace_dir, steps=3):
    """``steps`` TrainStep calls of a 4 -> 2 linear model under a traced
    clean slate: span rows and the step statistics."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    if pkg_name == "ref":
        import paddle_tpu as paddle
        import paddle_tpu.nn as jnn
        from paddle_tpu.jit import TrainStep
        m = jnn.Linear(4, 2)
        step = TrainStep(m, lambda mm, a: (mm(a) ** 2).mean(),
                         paddle.optimizer.SGD(learning_rate=0.1,
                                              parameters=m.parameters()))
        run = lambda: step(paddle.to_tensor(x))          # noqa: E731
        pkg = REF
    else:
        import paddle_tpu_torch.nn as tnn
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.optimizer import SGD
        m = tnn.Linear(4, 2, device="cpu")
        step = TrainStep(m, lambda mm, a: (mm(a) ** 2).mean(),
                         SGD(learning_rate=0.1))
        run = lambda: step(torch.from_numpy(x))          # noqa: E731
        pkg = PORT
    pkg.obs.tracer.enable(str(trace_dir), label=pkg_name)
    try:
        for _ in range(steps):
            run()
    finally:
        pkg.obs.tracer.disable()
    stats = pkg.monitor.all_stats()
    spans = [json.loads(line) for line in open(
        os.path.join(str(trace_dir), f"trace_{pkg_name}.jsonl"))]
    return (_shape(REF.obs.span_summary(str(trace_dir))),
            [s["attrs"]["step"] for s in spans if s.get("name") ==
             "train.step"],
            {k: stats.get(k) for k in ("train_steps_total",
                                       "jit_compiles_total",
                                       "jit_cache_hits_total",
                                       "jit_compiles_new_signature_total")},
            pkg.monitor.all_histograms()["train_step_ms"]["count"])


def test_train_step_records_as_the_reference(tmp_path):
    with clean_planes():
        got = [_train(name, tmp_path / name) for name in ("ref", "port")]
    assert got[1] == got[0]
    assert got[1][0] == [("jit.compile", 1, 0, None),
                         ("train.step", 3, 0, None)]
    assert got[1][2]["train_steps_total"] == 3 and got[1][3] == 3


def test_ranks_as_threads_record_each_step_once(tmp_path):
    """dp = 2 on LoopbackWorld threads: the reference's one controller
    records a step once, and so does the port's process."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep
    from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep
    torch.manual_seed(0)
    init = tnn.Linear(4, 2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 4)).astype(np.float32))

    def fn(rank, mesh):
        out = []
        for make in (lambda m: ShardedTrainStep(m, _loss, SGD(0.1),
                                                mesh=mesh),
                     lambda m: ShardedUpdateTrainStep(
                         m, _loss, SGD(0.1), mesh=mesh, wire_dtype="f32")):
            step = make(copy.deepcopy(init))
            out.append([float(step(x)) for _ in range(3)])
        return out
    with clean_planes():
        PORT.obs.tracer.enable(str(tmp_path), label="dp2")
        try:
            losses = LoopbackWorld(2).run(fn)
        finally:
            PORT.obs.tracer.disable()
        stats = PORT.monitor.all_stats()
        rows = {r["name"]: r["count"]
                for r in REF.obs.span_summary(str(tmp_path))}
        compiles = PORT.health.compile_report()
        hist = PORT.monitor.all_histograms()["train_step_ms"]["count"]
    assert losses[0] == losses[1]
    assert stats["train_steps_total"] == 6 and hist == 6
    assert rows["train.step"] == 3 and rows["zero.step"] == 3
    assert rows["zero.reduce_scatter"] == rows["zero.all_gather"] == 3
    assert compiles["TrainStep"]["compiles"] == 1
    assert compiles["TrainStep"]["calls"] == 3


def _loss(m, a):
    return (m(a) ** 2).mean()


def test_ps_prefetch_spans_close_with_their_fate(tmp_path):
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.models import WideDeepHost
    from paddle_tpu_torch.optimizer import Adam
    torch.manual_seed(0)
    emb = ps.DistributedEmbedding(100, 5, mode="sync", device="cpu")
    model = WideDeepHost(embedding_dim=4, num_fields=2, dense_dim=1,
                         hidden=(4,), device="cpu")
    step = ps.PSTrainStep(
        model, lambda m, rows, x: m(rows, x).mean(), Adam(learning_rate=0.1),
        emb, prefetch_depth=1, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (4, 8, 2))
    x = torch.ones(8, 1)
    with clean_planes():
        PORT.obs.tracer.enable(str(tmp_path), label="ps")
        try:
            step.prefetch(ids[0])
            step.prefetch(ids[1])
            step(ids[0], x)          # issues ids[1]
            step.prefetch(ids[2])
            step(ids[1], x)          # takes it, issues ids[2]
            step(ids[3], x)          # ids[2]'s rows discarded
            step.flush()
        finally:
            PORT.obs.tracer.disable()
        stats = PORT.monitor.all_stats()
        report = PORT.health.compile_report()["PSTrainStep"]
    spans = [json.loads(line) for line in open(tmp_path / "trace_ps.jsonl")]
    pre = [(s["status"], s["attrs"].get("reason"))
           for s in spans if s.get("name") == "ps.prefetch"]
    assert pre == [("ok", None), ("error", "reordered")]
    steps = [s for s in spans if s.get("name") == "train.step"]
    assert [[ln["kind"] for ln in s.get("links", ())] for s in steps] == [
        [], ["prefetch"], ["sync_fallback"]]
    assert (stats["ps_prefetch_hits_total"],
            stats["ps_prefetch_misses_total"]) == (1, 1)
    assert (report["compiles"], report["calls"]) == (1, 3)
