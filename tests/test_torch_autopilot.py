"""The port's autopilot (paddle_tpu_torch/framework/autopilot.py) against
the reference's on the CPU.

Both controllers get the same targets (fake PS step, client, scaler,
resilient wrapper, elastic agent), the same injectable clock and the
same scripted signals (drawn from a numpy seed: PS-wait storms, quiet
intervals, loss-scale collapses, NaN streaks, overdue stragglers, step
times that worsen after an action), with the ``autopilot.act`` chaos
point armed alike: their decisions (taken, suppressed by hysteresis,
cooldown or budget, errored, reverted), the knobs they leave and the
monitor counters are equal.  A dry run decides alike and moves nothing.
``maybe_apply_tuned_profile`` sets the same flags from a profile file,
once a process, and degrades alike on a corrupt one.  The port's
``PSTrainStep`` has the ``set_prefetch_depth`` actuator.
"""
import json

import numpy as np
import pytest

from paddle_tpu.framework import autopilot as jap
from paddle_tpu_torch.framework import autopilot as tap

from torch_planes_common import PORT, REF, clean_planes


class Clock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


class Step:
    def __init__(self):
        self.prefetch_depth = 0

    def set_prefetch_depth(self, d):
        prev, self.prefetch_depth = self.prefetch_depth, max(0, int(d))
        return prev


class Client:
    def __init__(self):
        self.wire_dtype = "bf16"

    def set_wire_dtype(self, wd):
        prev, self.wire_dtype = self.wire_dtype, str(wd)
        return prev


class Scaler:
    def __init__(self):
        self.incr_every, self.tightens = 1000, 0

    def tighten_growth(self, factor=4.0):
        prev = {"incr_every_n_steps": self.incr_every, "good_steps": 0}
        self.incr_every = int(self.incr_every * factor)
        self.tightens += 1
        return prev

    def restore_growth(self, prev):
        self.incr_every = int(prev["incr_every_n_steps"])


class Resilient:
    def __init__(self):
        self.consecutive_bad, self.restores = 0, 0

    def restore(self):
        self.restores += 1


class Agent:
    def __init__(self):
        self.enforced = []

    def straggler_overdue(self, deadline):
        return []

    def enforce_straggler_policy(self, deadline):
        self.enforced.append(deadline)


def _signals(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = {"step_ms": float(rng.uniform(4, 12))}
        r = rng.random()
        if r < 0.4:
            s["blame_per_step"] = {"ps_wait": float(rng.uniform(20, 40)),
                                   "compute": float(rng.uniform(5, 20))}
        elif r < 0.55:
            s["scale_collapses"] = int(rng.integers(1, 3))
        elif r < 0.7:
            s["nan_skips"] = int(rng.integers(1, 4))
            s["consecutive_bad"] = int(rng.integers(0, 3))
        elif r < 0.8:
            s["stragglers_overdue"] = ["w1"]
        out.append(s)
    return out


def _drive(mod, pkg, signals, dry_run=False, hysteresis=2):
    clock = Clock()
    targets = dict(step=Step(), client=Client(), scaler=Scaler(),
                   resilient=Resilient(), agent=Agent())
    ctl = mod.Controller(clock=clock, interval_steps=1,
                         hysteresis=hysteresis, cooldown_s=25.0,
                         max_actions=3, window_s=120.0,
                         rollback_intervals=1, rollback_tolerance=0.25,
                         max_prefetch_depth=3, straggler_deadline=60.0,
                         dry_run=dry_run, **targets)
    it = iter(signals)

    def collect():
        base = {"steps": 4, "step_ms": 5.0, "rpc_ms": None,
                "rpc_count": 0, "anomalies": 0, "scale_collapses": 0,
                "nan_skips": 0, "consecutive_bad": 0, "blame_per_step": {},
                "wire_dtype": ctl.client().wire_dtype,
                "prefetch_depth": ctl.step.prefetch_depth,
                "stragglers_overdue": []}
        base.update(next(it))
        return base
    ctl._collect = collect
    pkg.chaos.reset(7)
    pkg.chaos.arm("autopilot.act", mode="error", nth=2, n_times=1)
    for _ in signals:
        ctl.evaluate()
        clock.t += 10.0
    pkg.chaos.reset(0)
    t = targets
    knobs = (t["step"].prefetch_depth, t["client"].wire_dtype,
             t["scaler"].incr_every, t["scaler"].tightens,
             t["resilient"].restores, len(t["agent"].enforced))
    stats = {k: pkg.monitor.get_stat(k) for k in (
        "autopilot_actions_total", "autopilot_suppressed_total",
        "autopilot_act_errors_total", "autopilot_reverts_total")}
    return ctl.decisions, knobs, stats, ctl.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_decisions_under_the_injected_clock(seed):
    sig = _signals(seed, 24)
    with clean_planes():
        want = _drive(jap, REF, sig)
        got = _drive(tap, PORT, sig)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    kinds = {d["kind"] for d in got[0]}
    assert "taken" in kinds and "suppressed" in kinds


def test_dry_run_decides_alike_and_moves_nothing():
    sig = _signals(5, 16)
    with clean_planes():
        want = _drive(jap, REF, sig, dry_run=True, hysteresis=1)
        got = _drive(tap, PORT, sig, dry_run=True, hysteresis=1)
    assert got[0] == want[0]
    assert any(d["kind"] == "taken" for d in got[0])
    assert got[1] == (0, "bf16", 1000, 0, 0, 0)


def test_tuned_profile_sets_the_same_flags(tmp_path):
    prof = {"schema_version": 1, "knobs": {"prefetch_depth": 3,
                                           "wire_dtype": "int8"},
            "objective": {"metric": "examples_per_s", "value": 1.0}}
    good = tmp_path / "good.json"
    good.write_text(json.dumps(prof))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    names = ["ps_prefetch_depth", "ps_wire_dtype", "zero_wire_dtype",
             "autotune_profile"]
    for path in (good, bad):
        out = []
        for mod, pkg in ((jap, REF), (tap, PORT)):
            with clean_planes({"autotune_profile": str(path),
                               "ps_prefetch_depth": 1,
                               "ps_wire_dtype": "bf16",
                               "zero_wire_dtype": "bf16"}):
                mod._applied_profiles.discard(str(path))
                first = mod.maybe_apply_tuned_profile(source="t")
                again = mod.maybe_apply_tuned_profile(source="t")
                out.append((first is None, again,
                            pkg.flags.get_flags(names),
                            pkg.monitor.get_stat(
                                "autopilot_profile_errors_total")))
                mod._applied_profiles.discard(str(path))
        assert out[0] == out[1]


def test_ps_train_step_has_the_prefetch_actuator():
    from paddle_tpu_torch.distributed.ps import PSTrainStep
    assert callable(getattr(PSTrainStep, "set_prefetch_depth", None))
    ctl = tap.Controller(clock=Clock(), step=Step(), interval_steps=1)
    assert tap.default_actuators()["prefetch.deepen"].available(ctl)
