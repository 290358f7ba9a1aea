"""``paddle_tpu_torch.profiler`` against the reference on the CPU:

- the host aggregate table: the same event names and counts for the same
  nested ``RecordEvent`` / ``record_event`` / decorator calls, a
  ``TrainStep`` and tracer spans run under ``start_profiler("CPU")``; the
  host chrome trace and its span cap (``FLAGS_profiler_max_spans``) drop
  and report as the reference's; the report prints every name;
- bad arguments raise as in the reference;
- no fallback: a device state on a machine with no card raises the
  ``RuntimeError`` naming ``is_available`` and leaves the profiler off;
- the ranges reach PyTorch's profiler: under ``torch.profiler.profile``
  a ``TrainStep`` call shows the ``TrainStep`` and ``TrainStep.update``
  ranges (``tools/profile_gpt.py`` groups by them) and ``Predictor.run``
  shows when profiling is enabled in its config."""
import json

import numpy as np
import pytest
import torch

from torch_planes_common import BOTH, PORT, REF, clean_planes


def _session(pkg, path):
    prof = pkg.profiler
    prof.start_profiler("CPU")
    with prof.RecordEvent("outer"):
        for _ in range(3):
            with prof.record_event("inner"):
                pass

    @prof.RecordEvent("decorated")
    def f(a):
        return a + 1
    assert f(1) == 2 and f.__name__ == "f"
    tr = pkg.obs.Tracer(str(path.parent / "spans"), label="p")
    with tr.start_span("traced"):
        pass
    prof.stop_profiler(sorted_key="calls", profile_path=str(path))
    with open(path) as fh:
        trace = json.load(fh)
    counts = {n: e[0] for n, e in prof._events.items()}
    names = sorted(ev["name"] for ev in trace["traceEvents"])
    return counts, names, trace["metadata"]


def test_aggregates_and_host_trace_match_the_reference(tmp_path, capsys):
    got = []
    with clean_planes({"profiler_max_spans": 4}):
        for pkg, name in zip(BOTH, ("ref", "port")):
            got.append(_session(pkg, tmp_path / name / "host.json"))
            report = capsys.readouterr().out
            assert "Profiling Report" in report
            assert all(n in report for n in got[-1][0])
    assert got[1] == got[0]
    counts, names, meta = got[1]
    assert counts == {"outer": 1, "inner": 3, "decorated": 1, "traced": 1}
    assert meta == {"dropped_spans": 2, "max_spans": 4} and len(names) == 4


def test_bad_arguments_raise():
    for pkg in BOTH:
        with pytest.raises(ValueError):
            pkg.profiler.start_profiler("NPU")
        with pytest.raises(ValueError):
            pkg.profiler.start_profiler("CPU", tracer_option="Everything")
        with pytest.raises(ValueError):
            pkg.profiler._print_report("bogus")
        assert not pkg.profiler.is_profiling()


def test_device_state_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for state in ("GPU", "All"):
        with pytest.raises(RuntimeError, match="is_available"):
            PORT.profiler.start_profiler(state, trace_dir=str(tmp_path))
        assert not PORT.profiler.is_profiling()
    with pytest.raises(RuntimeError, match="is_available"):
        with PORT.profiler.profiler("All", trace_dir=str(tmp_path)):
            pass


def _step(pkg):
    x = np.ones((4, 3), np.float32)
    if pkg is REF:
        import paddle_tpu as paddle
        import paddle_tpu.nn as jnn
        from paddle_tpu.jit import TrainStep
        m = jnn.Linear(3, 1)
        step = TrainStep(m, lambda mm, a: mm(a).mean(), paddle.optimizer.SGD(
            learning_rate=0.1, parameters=m.parameters()))
        return lambda: step(paddle.to_tensor(x))
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD
    step = TrainStep(tnn.Linear(3, 1, device="cpu"),
                     lambda mm, a: mm(a).mean(), SGD(learning_rate=0.1))
    return lambda: step(torch.from_numpy(x))


def test_train_step_ranges(tmp_path):
    got = []
    with clean_planes():
        for pkg in BOTH:
            run = _step(pkg)
            pkg.profiler.start_profiler("CPU")
            for _ in range(3):
                run()
            pkg.profiler.stop_profiler(profile_path=str(tmp_path / "h"))
            got.append({n: e[0] for n, e in pkg.profiler._events.items()})
    assert got[1] == got[0] == {"TrainStep": 3}
    run = _step(PORT)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    keys = {e.key for e in prof.key_averages()}
    assert {"TrainStep", "TrainStep.update"} <= keys


def test_predictor_run_range(tmp_path):
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec
    path = str(tmp_path / "m")
    jit.save(tnn.Linear(3, 2, device="cpu"), path,
             input_spec=[InputSpec([None, 3], "float32")])
    cfg = inference.Config(path + ".pdmodel", path + ".pdparams")
    cfg.disable_gpu()
    cfg.enable_profile()
    pred = inference.create_predictor(cfg)
    pred.get_input_handle("input_0").copy_from_cpu(
        np.ones((2, 3), np.float32))
    with clean_planes():
        PORT.profiler.start_profiler("CPU")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pred.run()
        PORT.profiler.stop_profiler(profile_path=str(tmp_path / "h"))
        assert PORT.profiler._events["Predictor.run"][0] == 1
    assert "Predictor.run" in {e.key for e in prof.key_averages()}
