"""The port's blame plane (paddle_tpu_torch/framework/blame.py) against
the reference's on the CPU.

The same spans give the same blame in both packages, to the exact float:
a span list drawn from a numpy seed (steps with PS, compile, collective
and other children, prefetch producers with and without ``done_ts``,
ingest and sync-fallback links, gaps between steps, a dangling link),
the span files of a traced port ``TrainStep`` read by each package's
``load_trace_dir``, their merge by the reference's ``tools/trace_merge``
and the chrome trace of ``torch.profiler`` read by ``from_chrome_trace``
with ``TrainStep`` as the step span.  ``summary``, ``check``,
``format_blame`` and ``publish`` (the monitor's histograms and gauges)
agree too.
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.framework import blame as jblame
from paddle_tpu_torch.framework import blame as tblame

from torch_planes_common import PORT, REF, REPO, clean_planes

NAMES = ("ps.pull", "ps.push", "jit.compile", "dp.sync", "host.cb",
         "ingest.fetch", "cc.allreduce")


def _random_spans(seed, n_steps=12):
    """A span list: ``n_steps`` train.step spans on two threads with
    children and linked producers, from a numpy seed."""
    rng = np.random.default_rng(seed)
    spans, t = [], {0: 0.0, 1: 0.0}
    sid = 0

    def span(name, ts, dur, parent=None, tid=0, attrs=None, links=None):
        nonlocal sid
        sid += 1
        s = {"id": f"s{sid}", "parent": parent, "name": name,
             "ts": float(ts), "end": float(ts + dur), "dur": float(dur),
             "tid": tid, "lane": 0, "status": "ok", "attrs": attrs or {},
             "links": links or []}
        spans.append(s)
        return s
    for i in range(n_steps):
        tid = i % 2
        t[tid] += float(rng.uniform(0, 3e3))          # the gap
        t0, dur = t[tid], float(rng.uniform(5e3, 2e4))
        links = []
        for kind in ("prefetch", "ingest", "sync_fallback"):
            if rng.random() < 0.5:
                pts = t0 - float(rng.uniform(0, 8e3))
                attrs = {}
                if kind == "prefetch" and rng.random() < 0.5:
                    attrs["done_ts"] = pts + float(rng.uniform(0, 9e3))
                p = span("ps.prefetch" if kind != "ingest" else
                         "ingest.fetch", pts, float(rng.uniform(1e3, 1e4)),
                         tid=tid, attrs=attrs)
                links.append({"span": p["id"], "kind": kind})
        if i == 5:
            links.append({"span": "ghost", "kind": "prefetch"})
        st = span("train.step", t0, dur, tid=tid, links=links)
        for _ in range(int(rng.integers(0, 4))):
            name = NAMES[int(rng.integers(len(NAMES)))]
            a = t0 + float(rng.uniform(0, dur))
            attrs = {"category": "collective"} if name == "dp.sync" else {}
            c = span(name, a, float(rng.uniform(0, t0 + dur - a)),
                     parent=st["id"], tid=tid, attrs=attrs)
            if rng.random() < 0.3:
                span("ps.rpc", c["ts"], c["dur"] / 2, parent=c["id"],
                     tid=tid)
        t[tid] = t0 + dur
    return spans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_span_lists_blame_alike(seed):
    spans = _random_spans(seed)
    want = jblame.compute_blame([dict(s) for s in spans])
    got = tblame.compute_blame([dict(s) for s in spans])
    assert got == want
    assert want["unresolved_links"] == 1
    assert tblame.summary(got) == jblame.summary(want)
    for tol, top in ((0.05, None), (None, "compute"), (None, "ps_wait")):
        assert tblame.check(got, tol, top) == jblame.check(want, tol, top)
    assert tblame.format_blame(got) == jblame.format_blame(want)
    assert tblame.categorize("ps.x", link_kind="ingest") == \
        jblame.categorize("ps.x", link_kind="ingest")


def test_publish_into_both_monitors():
    spans = _random_spans(3)
    with clean_planes():
        jblame.publish(jblame.compute_blame(spans))
        tblame.publish(tblame.compute_blame(spans))
        assert PORT.monitor.all_histograms() == REF.monitor.all_histograms()
        for c in tblame.CATEGORIES:
            assert PORT.monitor.get_stat(f"blame_{c}_pct") == \
                REF.monitor.get_stat(f"blame_{c}_pct")


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A port TrainStep traced for 4 steps (a detached PS producer linked
    into each), under torch.profiler (the CPU's activities: the port's
    ``start_profiler`` wants a card): the span dir and the chrome
    trace."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD
    d = tmp_path_factory.mktemp("blame_trace")
    tr = PORT.obs.tracer
    torch.manual_seed(0)
    step = TrainStep(nn.Linear(4, 2, device="cpu"),
                     lambda m, x: m(x).square().mean(),
                     SGD(learning_rate=0.1))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 4)).astype(np.float32))
    tr.enable(str(d), label="blame")
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        for _ in range(4):
            p = tr.start_span("ps.prefetch", detached=True)
            p.end()
            tr.link_next(p.span_id, "prefetch")
            step(x)
    finally:
        prof.stop()
        tr.disable()
    chrome = str(d / "chrome" / "torch_trace.json")
    os.makedirs(os.path.dirname(chrome))
    prof.export_chrome_trace(chrome)
    return str(d), chrome


def test_trace_dir_and_merge_blame_alike(traced_run):
    """The port's span files: each package's ``load_trace_dir`` reads the
    same spans and blames them alike; the reference's ``trace_merge``
    of them goes through both ``from_chrome_trace``."""
    import sys
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tools import trace_merge
    d, _ = traced_run
    got = tblame.load_trace_dir(d)
    assert got == jblame.load_trace_dir(d)
    res = tblame.compute_blame(got)
    assert res["n_steps"] == 4 and res == jblame.compute_blame(got)
    merged = trace_merge.merge(
        [os.path.join(d, f) for f in sorted(os.listdir(d))
         if f.startswith("trace_")])
    assert tblame.from_chrome_trace(merged) == \
        jblame.from_chrome_trace(merged)
    assert tblame.compute_blame(tblame.from_chrome_trace(merged)) == \
        jblame.compute_blame(jblame.from_chrome_trace(merged))


def test_profiler_chrome_trace_blames_alike(traced_run):
    """torch.profiler's chrome trace, with the port's ``TrainStep`` range
    as the step span: the same spans and shares in both packages."""
    _, chrome = traced_run
    with open(chrome) as f:
        trace = json.load(f)
    spans = tblame.from_chrome_trace(trace)
    assert spans == jblame.from_chrome_trace(trace)
    res = tblame.compute_blame(spans, step_span="TrainStep")
    assert res["n_steps"] == 4
    assert res == jblame.compute_blame(spans, step_span="TrainStep")
