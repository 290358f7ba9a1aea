"""``framework.health`` of the port against the reference on the CPU:

- ``Detector``: the same anomalies (indices, z-scores, baselines) on the
  same value streams: spikes, a level shift that re-baselines, NaNs in and
  after warm-up, a flat stream's jitter; ``HealthMonitor``'s counters and
  ``health.anomaly`` events, a swallowed ``health.detector`` fault, the
  arming from ``FLAGS_health_detectors`` (default set, JSON, a typo);
- compile observability: ``classify_recompile`` per cause, and
  ``compile_report`` counts and causes for ``gpt_tiny`` under
  ``TrainStep`` (and ``multi_step``) over the same sequence of shapes in
  both packages, ``to_static``'s static-argument change, and the
  steady-state recompiles with their ``health.compile_storm`` event;
- the CPU memory gauge against a known allocation (a view not counted
  twice), the tags, the watermark event and ``maybe_sample_memory``'s
  cadence;
- ``amp.GradScaler.update``: ``amp_loss_scale`` and the
  ``numerics.scale_collapse`` events for the same overflow sequence."""
import math

import numpy as np
import pytest
import torch

from torch_planes_common import BOTH, PORT, REF, clean_planes

STREAMS = {
    "spikes": [10.0 + 0.1 * math.sin(i) for i in range(30)]
    + [60.0] + [10.0] * 5 + [0.5, 10.1],
    "shift": [5.0] * 20 + [50.0] * 80,
    "nan": [1.0, float("nan"), 1.0, 1.0, 1.0, 1.0, float("inf"), 1.0, 1.2],
    "jitter": [100.0 + (i % 3) * 0.5 for i in range(40)] + [100.0, 180.0],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_detectors_flag_the_same_observations(name):
    got = []
    for pkg in BOTH:
        det = pkg.health.Detector(name, warmup=8, window=16,
                                  z_threshold=6.0, max_consecutive=10,
                                  clock=lambda: 0.0)
        flagged = [a.to_dict() for a in map(det.update, STREAMS[name]) if a]
        got.append((flagged, det.snapshot(), det.baseline(),
                    det.last_value()))
        det.reset()
        assert det.snapshot()["n"] == 0
    assert repr(got[1]) == repr(got[0])
    assert got[1][0], "nothing flagged"


def test_health_monitor_counts_swallows_and_arms():
    got = []
    with clean_planes():
        for pkg in BOTH:
            h = pkg.health
            det = h.watch("train_step_ms", warmup=4, z_threshold=5.0)
            assert h.watch("train_step_ms") is det          # idempotent
            for v in [10.0, 10.2, 9.9, 10.1, 10.0, 55.0, 10.0]:
                h.observe("train_step_ms", v)
            assert h.observe("unwatched", 1.0) is None
            with pkg.chaos.inject("health.detector", mode="error", nth=1):
                assert h.observe("train_step_ms", 99.0) is None
            events = [e["attrs"] for e in pkg.obs.flight.recent(
                10, kind="health.anomaly")]
            got.append((events, {k: v for k, v in
                                 pkg.monitor.all_stats().items()
                                 if k.startswith("health_")},
                        h.snapshot()["signals"], h.enabled()))
            h.reset()
        for spec in ("default", '{"ps_rpc_ms": {"warmup": 5}}',
                     '{"ps_rpc_ms": {"warmp": 5}}'):
            armed = []
            for pkg in BOTH:
                pkg.flags.set_flags({"health_detectors": spec})
                mon = pkg.health.HealthMonitor()
                armed.append((sorted(mon.detectors()) if mon.enabled
                              else [], pkg.monitor.get_stat(
                                  "health_config_errors_total")))
            assert armed[1] == armed[0], spec
        for pkg in BOTH:
            pkg.flags.set_flags({"health_detectors": ""})
    assert got[1] == got[0]
    assert got[1][1]["health_observe_errors_total"] == 1
    assert [e["index"] for e in got[1][0]] == [6]


def test_classify_recompile_per_cause():
    sig = (("T", (4, 6), "float32"), ("A", (8,), "int64"))
    cases = [((sig, []),), ((("T", (8, 6), "float32"), ("A", (8,), "int64")),
                            [sig]),
             ((("T", (4, 6), "bfloat16"), ("A", (8,), "int64")), [sig]),
             ((("S", 3), ("A", (8,), "int64")),
              [(("S", 7), ("A", (8,), "int64"))]),
             (sig + (True,), [sig]),
             ((("S", 3), ("T", (16, 6), "float32")),
              [(("S", 7), ("T", (4, 6), "float32"))]),
             (("multi", False, ("T", (2,), "float32")),
              [("multi", True, ("T", (2,), "float32"))])]
    for case in cases:
        args = case[0] if len(case) == 1 else case
        want = REF.health.classify_recompile(*args)
        assert PORT.health.classify_recompile(*args) == want, case


def _gpt_compiles(pkg_name):
    """gpt_tiny (1 layer) under TrainStep over one sequence of batch
    shapes, then multi_step: the compile report and counters."""
    from paddle_tpu_torch.models import gpt_tiny as t_tiny
    cfg = dict(num_layers=1, max_seq_len=32)
    rng = np.random.default_rng(0)
    shapes = [(2, 16), (2, 16), (2, 32), (2, 16), (4, 16), (2, 32)]
    batches = [rng.integers(0, 64, s) for s in shapes]
    multi = rng.integers(0, 64, (2, 2, 16))
    if pkg_name == "ref":
        import paddle_tpu as paddle
        from paddle_tpu.jit import TrainStep
        from paddle_tpu.models import GPT, gpt_loss, gpt_tiny
        paddle.seed(0)
        m = GPT(gpt_tiny(**cfg))
        step = TrainStep(m, gpt_loss, paddle.optimizer.SGD(
            learning_rate=0.01, parameters=m.parameters()))
        to = paddle.to_tensor
        pkg = REF
    else:
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.models import GPT, gpt_loss
        from paddle_tpu_torch.optimizer import SGD
        m = GPT(t_tiny(**cfg), device="cpu")
        step = TrainStep(m, gpt_loss, SGD(learning_rate=0.01))
        to = torch.from_numpy
        pkg = PORT
    run = [lambda ids=ids: step(to(ids), to(ids)) for ids in batches] + [
        lambda: step.multi_step(to(multi), to(multi))] * 2
    if pkg is REF:
        # one device for the reference, as the port's tests pin it
        import jax
        from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
        prev = get_mesh()
        set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
        try:
            for fn in run:
                fn()
        finally:
            set_mesh(prev)
    else:
        for fn in run:
            fn()
    rep = {site: {k: v for k, v in r.items() if k != "compile_ms_total"}
           for site, r in pkg.health.compile_report().items()}
    stats = {k: v for k, v in pkg.monitor.all_stats().items()
             if k.startswith("jit_") or k == "train_steps_total"}
    return rep, stats, pkg.monitor.all_histograms()["compile_ms"]["count"]


def test_compile_report_for_gpt_tiny_matches_the_reference():
    with clean_planes():
        got = [_gpt_compiles(name) for name in ("ref", "port")]
    assert got[1] == got[0]
    rep = got[1][0]
    assert rep["TrainStep"]["causes"] == {"new_signature": 1,
                                          "shape_change": 2}
    assert rep["TrainStep"]["calls"] == 6
    assert rep["TrainStep.multi_step"]["compiles"] == 1
    assert got[1][1]["train_steps_total"] == 10


def _static_and_storm(pkg):
    if pkg is REF:
        import paddle_tpu as paddle
        from paddle_tpu.jit import to_static
        to = paddle.to_tensor
    else:
        from paddle_tpu_torch.jit import to_static
        to = torch.from_numpy

    @to_static
    def f(x, k):
        return x * k
    x = to(np.ones((4,), np.float32))
    for k in (2.0, 2.0, 3.0):
        f(x, k)
    for n in range(1, 7):                   # a fresh shape every call
        f(to(np.ones((n,), np.float32)), 3.0)
    rep = pkg.health.compile_report()["to_static:f"]
    storms = [(e["attrs"]["site"], e["attrs"]["post_warmup_compiles"],
               e["attrs"]["causes"]) for e in pkg.obs.flight.recent(
                   20, kind="health.compile_storm")]
    return ({k: v for k, v in rep.items() if k != "compile_ms_total"},
            pkg.monitor.get_stat("jit_recompiles_steady_total"), storms)


def test_to_static_site_and_compile_storm():
    with clean_planes({"health_compile_warmup_calls": 3,
                       "health_compile_storm_k": 2}):
        got = [_static_and_storm(pkg) for pkg in BOTH]
    assert got[1] == got[0]
    assert got[1][0]["causes"]["static_arg_change"] == 1
    assert got[1][2] and got[1][2][0][0] == "to_static:f"


def test_cpu_memory_gauge_and_sampling():
    with clean_planes({"health_mem_sample_every": 2}):
        h = PORT.health
        h.memory.reset()
        before = h.memory.sample()["live_bytes"]
        block = torch.empty(1 << 21, dtype=torch.float32)     # 8 MiB
        views = (block[:10], block.view(2, -1))               # not counted
        got = h.memory.sample(tags={"params": 123})
        assert got["live_bytes"] - before == block.untyped_storage().nbytes()
        assert got["peak_bytes"] >= got["live_bytes"]
        stats = PORT.monitor.all_stats()
        assert stats["device_mem_live_bytes"] == got["live_bytes"]
        assert stats["device_mem_params_bytes"] == 123
        marks = PORT.obs.flight.recent(10, kind="health.mem_watermark")
        assert marks and marks[-1]["attrs"]["tags"] == {"params": 123}
        h.memory.track("ingest", 77)
        assert PORT.monitor.get_stat("device_mem_ingest_bytes") == 77
        calls = []
        samples = [h.maybe_sample_memory(lambda: calls.append(1) or {})
                   for _ in range(4)]
        assert [s is not None for s in samples].count(True) == 2
        assert len(calls) == 2
        assert h.memory.profile("unused.pickle") is None     # no CUDA here
        del views, block
        h.memory.reset()


def test_grad_scaler_records_as_the_reference():
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp
    overflow = [True] * 9 + [False] * 3 + [True] * 4
    got = []
    with clean_planes({"numerics_scale_collapse_k": 2}):
        for pkg, amp in ((REF, jamp), (PORT, tamp)):
            sc = amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)
            scales = []
            for bad in overflow:
                sc._found_inf = bad
                sc.update()
                scales.append(pkg.monitor.get_stat("amp_loss_scale"))
            got.append((scales, pkg.monitor.get_stat(
                "amp_scale_collapses_total"), [
                    e["attrs"] for e in pkg.obs.flight.recent(
                        20, kind="numerics.scale_collapse")]))
    assert got[1] == got[0]
    assert got[1][1] == 6
