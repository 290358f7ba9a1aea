"""``framework.monitor`` and ``framework.locks`` of the port against the
reference on the CPU, both packages driven by the same calls from the same
seeds after a clean slate (``tests/torch_planes_common.py``):

- the Prometheus text byte for byte, and ``snapshot()`` equal, after a
  seeded mix of adds, subtractions, gauges (NaN, infinities, per-leaf
  names), histogram observations in every bucket and the overflow, and a
  description;
- the reference's ``validate_prometheus`` accepts the port's text, and
  ``tools/health_check.py`` (``load_metrics``, ``build_report``,
  ``evaluate_gates``) reads it, and the port's JSON snapshot, as it reads
  the reference's;
- histogram percentiles and summaries;
- the lock watchdog: the same held-before graph, the same named cycle
  (``locks.cycle``), the long hold (``locks.long_hold``), the counters, a
  swallowed ``locks.observe`` fault; the tracked-lock protocol; the
  parameter server's host tables take the reference's tracked locks."""
import json
import pickle
import threading
import time

import numpy as np
import pytest

from torch_planes_common import BOTH, PORT, REF, clean_planes
from tools import health_check


def _drive_monitor(pkg, seed):
    m = pkg.monitor
    rng = np.random.default_rng(seed)
    names = ["ps.pull_rows", "train_steps_total", "grad_norm[fc1.weight]",
             "grad_norm[blocks[0].w]", "9lives", "input_stall_pct",
             'odd"name\\x']
    for _ in range(60):
        n = names[int(rng.integers(len(names)))]
        op = int(rng.integers(4))
        if op == 0:
            m.stat_add(n, int(rng.integers(1, 9)))
        elif op == 1:
            m.stat_sub(n, 2)
        elif op == 2:
            m.stat_set(n, float(rng.standard_normal()) * 10)
        else:
            m.observe(("train_step_ms", "ps_rpc_ms", "compile ms")[
                int(rng.integers(3))], float(rng.lognormal(2.0, 2.5)))
    m.stat_set("nan_gauge", float("nan"))
    m.stat_set("pos_inf", float("inf"))
    m.stat_set("neg_inf", float("-inf"))
    m.stat_set("flag_gauge", True)
    m.observe("huge", 1e9)                 # the overflow bucket
    m.describe("ps.pull_rows", "rows pulled\nfrom the host tables \\ all")


def test_prometheus_text_is_the_reference_s_byte_for_byte():
    with clean_planes():
        texts, snaps = [], []
        for pkg in BOTH:
            _drive_monitor(pkg, seed=11)
            texts.append(pkg.monitor.export_prometheus())
            snaps.append((pkg.monitor.snapshot(),
                          pkg.monitor.snapshot(labels=["grad_norm", "huge"])))
        assert texts[1] == texts[0]
        assert "grad_norm{leaf=\"blocks[0].w\"}" in texts[1]
        assert json.dumps(snaps[1], sort_keys=True) == json.dumps(
            snaps[0], sort_keys=True)


def test_reference_validator_and_health_check_read_the_port(tmp_path):
    with clean_planes():
        reads = []
        for pkg in BOTH:
            pkg.monitor.stat_set("health_anomalies_total", 0)
            pkg.monitor.stat_add("train_steps_total", 3)
            pkg.monitor.stat_add("jit_compiles_total", 1)
            for ms in (5.0, 7.5, 30.0):
                pkg.monitor.observe("train_step_ms", ms)
            text = pkg.monitor.export_prometheus()
            n = REF.obs.validate_prometheus(text, require_help=True)
            assert n == PORT.obs.validate_prometheus(text, require_help=True)
            prom = tmp_path / f"{pkg.monitor.__name__}.prom"
            prom.write_text(text)
            snap = tmp_path / f"{pkg.monitor.__name__}.json"
            snap.write_text(json.dumps(pkg.monitor.snapshot()))
            got = []
            for path in (prom, snap):
                loaded = health_check.load_metrics(str(path))
                report = health_check.build_report(loaded)
                got.append((loaded, report,
                            health_check.evaluate_gates(report)))
            assert got[0][2] == [] and got[1][2] == []
            assert got[1][0]["histograms"]["train_step_ms"]["count"] == 3
            reads.append((n, got))
        assert json.dumps(reads[1], sort_keys=True, default=str) == \
            json.dumps(reads[0], sort_keys=True, default=str)
        with pytest.raises(ValueError):
            PORT.obs.validate_prometheus("bad line here\n")


@pytest.mark.parametrize("values", [
    [0.05, 0.3, 0.3, 4.0, 17.0, 250.0, 250.0, 9000.0, 2e4],
    list(np.random.default_rng(5).lognormal(1.0, 1.5, 200))])
def test_histogram_percentiles_and_summaries(values):
    got = []
    for pkg in BOTH:
        h = pkg.monitor.Histogram("t")
        for v in values:
            h.record(v)
        got.append((h.summary(), [h.percentile(p) for p in
                                  (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)],
                    h.buckets()))
        h.reset()
        assert h.count == 0 and h.percentile(0.5) == 0.0
    assert got[1] == got[0]


def _watch(pkg, prefix):
    """Acquire A then B, then B then A (a cycle), hold C past the warn
    time, and probe one locks.observe fault: the watchdog's readings."""
    lk = pkg.locks
    lk.watchdog.reset()
    a, b = lk.lock(prefix + "a"), lk.rlock(prefix + "b")
    c = lk.lock(prefix + "c")
    with a:
        with b:
            with b:                          # reentrant: no self edge
                assert lk.held_locks() == [prefix + n
                                           for n in ("a", "b", "b")]
    with b:
        with a:
            pass
    with c:
        time.sleep(0.02)
    with pkg.chaos.inject("locks.observe", mode="error", nth=1):
        with a:                              # the fault is swallowed
            pass
    events = [(e["kind"], e["severity"],
               {k: v for k, v in e["attrs"].items()
                if k in ("cycle", "edge", "lock", "warn_ms")})
              for e in pkg.obs.flight.recent(50)
              if e["kind"].startswith("locks.")]
    stats = {k: v for k, v in pkg.monitor.all_stats().items()
             if k.startswith("lock_")}
    return (lk.watchdog.graph(), lk.watchdog.cycles(), lk.watchdog.seen(),
            lk.watchdog.errors, events, stats,
            pkg.monitor.all_histograms()["lock_hold_ms"]["count"])


def test_lock_watchdog_reports_as_the_reference():
    with clean_planes({"lock_watchdog": True, "lock_hold_warn_ms": 10.0}):
        got = [_watch(pkg, "test.wd.") for pkg in BOTH]
        for pkg in BOTH:
            pkg.locks.watchdog.reset()
    assert got[1] == got[0]
    graph, cycles, seen, errors, events, stats, holds = got[1]
    assert cycles == [["test.wd.a", "test.wd.b", "test.wd.a"]]
    assert [e[0] for e in events] == ["locks.cycle", "locks.long_hold"]
    assert errors == 1 and stats["lock_watchdog_errors_total"] == 1
    assert stats["lock_cycles_total"] == 1
    assert stats["lock_long_holds_total"] == 1


def test_tracked_lock_protocol():
    for pkg in BOTH:
        lk = pkg.locks
        plain, re_ = lk.lock("test.p"), lk.rlock("test.r")
        assert plain.acquire(False) and plain.locked()
        got = []
        t = threading.Thread(target=lambda: got.append(
            (plain.acquire(False), re_.locked())))
        with re_:
            t.start()
            t.join()
        plain.release()
        assert got == [(False, True)] and not plain.locked()
        assert repr(re_) == "TrackedLock('test.r', rlock)"
        back = pickle.loads(pickle.dumps(re_))
        assert (back.name, back.reentrant, back.locked()) == (
            "test.r", True, False)


def test_ps_host_tables_take_the_reference_s_tracked_locks():
    from paddle_tpu.distributed import ps as jps
    from paddle_tpu_torch.distributed import ps as tps
    with clean_planes({"lock_watchdog": True}):
        seen = []
        for pkg, ps in ((REF, jps), (PORT, tps)):
            pkg.locks.watchdog.reset()
            host = ps.HostEmbeddingTable(16, 4, seed=0)
            dyn = ps.HashEmbeddingTable(4, seed=0)
            for t in (host, dyn):
                t.pull(np.array([1, 3]))
                t.push(np.array([1, 3]), np.ones((2, 4), np.float32))
            assert type(host._lock).__name__ == "TrackedLock"
            seen.append(pkg.locks.watchdog.seen())
            pkg.locks.watchdog.reset()
    assert seen[1] == seen[0] == ["ps.dynamic_table", "ps.host_table"]
