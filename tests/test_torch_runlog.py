"""The port's run ledger (paddle_tpu_torch/framework/runlog.py) against
the reference's on the CPU.

``capture`` over the same monitor state, legs and trace dir gives the
same record in both packages but for the fields that name the time, the
host and the versions (``ts``, ``run_id`` and ``meta``'s ``time``,
``jax`` / ``torch`` / ``cuda``); the meta's other fields agree.  A
ledger written by one package reads back in the other, a torn tail is
skipped and isolated alike, the ``runlog.observe`` fault is swallowed
and counted alike, the bench-line parser and the importer agree, and
``TrainEpochRange`` appends its ``train_epoch`` record when
``FLAGS_runlog_dir`` is set, as the reference's does.
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.framework import runlog as jrun
from paddle_tpu_torch.framework import runlog as trun

from torch_planes_common import BOTH, PORT, REF, clean_planes

VARIES = ("ts", "run_id")
META_VARIES = ("time", "jax", "torch", "cuda", "device", "device_count")


def _feed(pkg):
    """The same statistics, histograms and flight events in one
    package's planes."""
    rng = np.random.default_rng(0)
    for v in rng.uniform(5, 50, 40):
        pkg.monitor.observe("train_step_ms", float(v))
    for op in ("pull", "push"):
        for v in rng.uniform(0.1, 3, 20):
            pkg.monitor.observe(f"ps_client_rpc_ms_{op}", float(v))
    pkg.monitor.stat_add("train_steps_total", 40)
    pkg.monitor.stat_add("jit_compiles_total", 2)
    pkg.monitor.stat_set("input_stall_pct", 3.5)
    pkg.obs.flight.record("health.anomaly", severity="warn", signal="x")


def _same_record(got, want):
    g = {k: v for k, v in got.items() if k not in VARIES}
    w = {k: v for k, v in want.items() if k not in VARIES}
    gm, wm = g.pop("meta"), w.pop("meta")
    assert g == w
    assert {k: v for k, v in gm.items() if k not in META_VARIES} == \
        {k: v for k, v in wm.items() if k not in META_VARIES}


def _traced(tmp_path):
    """A small span file in the tracer's format (the port's tracer)."""
    tr = PORT.obs.tracer
    tr.enable(str(tmp_path), label="r0")
    try:
        for _ in range(3):
            with tr.start_span("train.step"):
                with tr.start_span("ps.pull"):
                    pass
    finally:
        tr.disable()
    return str(tmp_path)


def test_capture_matches_reference(tmp_path):
    legs = [{"metric": "tokens_per_s", "value": 1.5e5, "unit": "tok/s"}]
    d = _traced(tmp_path)
    with clean_planes({"runlog_dir": ""}):
        for pkg in BOTH:
            _feed(pkg)
        want = jrun.capture("bench", label="gpt", legs=legs, trace_dir=d)
        got = trun.capture("bench", label="gpt", legs=legs, trace_dir=d)
        _same_record(got, want)
        assert got["summary"]["train_step_p99_ms"] > 0
        assert "blame" in got and got["blame"]["n_steps"] == 3
        assert got["meta"]["torch"] == torch.__version__
        lean_w = jrun.capture("bench", include_snapshot=False,
                              extra={"x": 1})
        lean_g = trun.capture("bench", include_snapshot=False,
                              extra={"x": 1})
        _same_record(lean_g, lean_w)


def test_ledger_crosses_packages_and_skips_a_torn_tail(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    with clean_planes():
        assert jrun.RunLedger(path).append({"kind": "a", "n": 1})
        assert trun.RunLedger(path).append({"kind": "b", "n": 2})
        with open(path, "a") as f:
            f.write('{"kind": "torn"')               # a crash mid-append
        assert trun.RunLedger(path).append({"kind": "c", "n": 3})
        for mod, pkg in ((trun, PORT), (jrun, REF)):
            led = mod.RunLedger(path)
            assert [r["kind"] for r in led.read()] == ["a", "b", "c"]
            assert [r["n"] for r in led.records(kind="b")] == [2]
            assert pkg.monitor.get_stat(
                "runlog_skipped_records_total") == 1


def test_observe_fault_is_swallowed_alike(tmp_path):
    with clean_planes():
        for mod, pkg in ((trun, PORT), (jrun, REF)):
            led = mod.RunLedger(str(tmp_path / f"{pkg is PORT}.jsonl"))
            with pkg.chaos.inject("runlog.observe", mode="error", nth=1):
                assert led.append({"kind": "x"}) is False
            assert led.append({"kind": "y"}) is True
            assert pkg.monitor.get_stat("runlog_write_errors_total") == 1
            assert pkg.obs.flight.recent(4, kind="runlog.write_error")
            assert [r["kind"] for r in led.read()] == ["y"]


def test_bench_lines_and_import_alike(tmp_path):
    tail = ("warming up\n"
            '{"metric": "a", "value": 1.0, "unit": "ms"}\n'
            '{"metric": "b", "val\n'
            "{not json}\n"
            '{"metric": "c", "value": 3, "unit": "x", "vs_baseline": 1.1}\n')
    assert trun.bench_record_to_legs(tail) == jrun.bench_record_to_legs(tail)
    f = tmp_path / "BENCH_r07.json"
    f.write_text(json.dumps({"n": 7, "tail": tail}))
    _same_record(trun.import_bench_file(str(f)),
                 jrun.import_bench_file(str(f)))
    g = tmp_path / "BENCH_bad.json"
    g.write_text("garbage")
    assert trun.import_bench_file(str(g)) is None is \
        jrun.import_bench_file(str(g))


def test_train_epoch_range_appends_its_record(tmp_path):
    """A completed ``TrainEpochRange`` with FLAGS_runlog_dir set appends
    one ``train_epoch`` record with the reference's epochs section; with
    the flag empty it appends nothing."""
    from paddle_tpu_torch.framework.auto_checkpoint import TrainEpochRange
    from paddle_tpu.framework.auto_checkpoint import \
        TrainEpochRange as JRange
    with clean_planes({"runlog_dir": str(tmp_path / "runs")}):
        list(TrainEpochRange(3, "port-run"))
        list(JRange(3, "ref-run"))
        recs = trun.RunLedger(trun.default_ledger_path()).read()
        by = {r["label"]: r for r in recs}
        assert by["port-run"]["kind"] == by["ref-run"]["kind"] == \
            "train_epoch"
        assert by["port-run"]["epochs"] == by["ref-run"]["epochs"] == \
            {"start": 0, "end": 2, "restored": -1}
    with clean_planes({"runlog_dir": ""}):
        list(TrainEpochRange(2, "off"))
        assert trun.default_ledger_path() is None
