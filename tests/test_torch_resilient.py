"""The port's ResilientTrainStep (paddle_tpu_torch/framework/resilient.py)
against the reference's on the CPU.

The two-branch step of ``torch_incident_common`` (the port's from the
reference builder's weights) takes 6 batches drawn from a numpy seed
with ``train.step_grads`` poisoning the aux input at the 3rd call, in
each package: one skip and one restore in both, the losses within 1e-5
(f32, the skipped one NaN in both), the final parameters within 1e-5,
and ``first_bad_leaf`` alike with ``FLAGS_numerics`` armed.  The port's
poisoned run is bitwise its own unwrapped ``TrainStep`` fed the same
batches without the poisoned one.  ``FLAGS_check_nan_inf`` inside the
wrapped step takes the same recovery; ``max_consecutive_bad`` raises;
``attach_durable`` persists only good steps; ``membership_changed``
snapshots before a re-form, and the snapshot restores in place.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_incident_common as common        # puts tools/ on the path
from torch_planes_common import PORT, REF, clean_planes

import health_check                            # tools/health_check.py

STEPS = 6


def _batches():
    return [common.batch(seed) for seed in range(STEPS)]


def _run(pkg, builder, to_tensor, flags, nth=3):
    with clean_planes(flags):
        step = builder(seed=0)
        pkg.chaos.arm("train.step_grads", mode="nan", nth=nth, n_times=1,
                      payload_index=1)
        losses, skipped, leaves = [], [], []
        for b in _batches():
            losses.append(float(step(*(to_tensor(a) for a in b))))
            skipped.append(step.last_step_skipped)
            leaves.append(step.last_bad_leaf)
        pkg.chaos.reset(0)
        params = {n: np.array(p._data if hasattr(p, "_data") else
                              p.detach().numpy())
                  for n, p in step.step.model.named_parameters()}
        counts = (pkg.monitor.get_stat("train_nan_skips_total"),
                  pkg.monitor.get_stat("train_restores_total"))
    return losses, skipped, leaves, params, counts, step


@pytest.mark.parametrize("numerics", [False, True])
def test_poisoned_run_matches_reference(numerics):
    flags = {"numerics": numerics, "incident": False}
    jl, js, jleaf, jp, jc, _ = _run(REF, health_check.build_incident_step,
                                    paddle.to_tensor, flags)
    tl, ts, tleaf, tp, tc, _ = _run(PORT, common.port_build_incident_step,
                                    torch.from_numpy, flags)
    assert ts == js == [False, False, True, False, False, False]
    assert tc == jc == (1, 1)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-6)
    assert tleaf == jleaf
    assert tleaf[2] == ("aux_w" if numerics else None)


def test_poisoned_run_is_bitwise_the_unpoisoned_skip_run():
    """The port's wrapped run with the 3rd batch poisoned and skipped:
    its good losses and final parameters are bitwise those of an
    unwrapped TrainStep fed the same batches without the 3rd."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import load_named_params
    from paddle_tpu_torch.optimizer import SGD
    tl, ts, _, tp, _, _ = _run(PORT, common.port_build_incident_step,
                               torch.from_numpy, {"numerics": False})
    net = common.TwoBranch()
    load_named_params(net, common.reference_weights(0))
    plain = TrainStep(net, common.two_branch_loss, SGD(learning_rate=0.05))
    batches = [b for i, b in enumerate(_batches()) if i != 2]
    want = [float(plain(*(torch.from_numpy(a) for a in b)))
            for b in batches]
    assert [loss for loss, s in zip(tl, ts) if not s] == want
    for n, p in net.named_parameters():
        assert np.array_equal(tp[n], p.detach().numpy())


def test_check_nan_inf_takes_the_same_recovery():
    tl, ts, _, tp, _, _ = _run(PORT, common.port_build_incident_step,
                               torch.from_numpy, {"numerics": False})
    cl, cs, _, cp, counts, _ = _run(PORT, common.port_build_incident_step,
                                    torch.from_numpy,
                                    {"numerics": False,
                                     "check_nan_inf": True})
    assert cs == ts and counts == (1, 1)
    assert np.isnan(cl[2]) and [a for a, s in zip(cl, cs) if not s] == \
        [a for a, s in zip(tl, ts) if not s]
    for n in tp:
        assert np.array_equal(cp[n], tp[n])


def test_consecutive_bad_steps_raise():
    with clean_planes({"numerics": False}):
        step = common.port_build_incident_step(seed=0,
                                               max_consecutive_bad=2)
        b = [torch.from_numpy(a) for a in common.batch()]
        PORT.chaos.arm("train.step_grads", mode="nan", every=1,
                       payload_index=1)
        try:
            step(*b)
            with pytest.raises(FloatingPointError, match="2 consecutive"):
                step(*b)
        finally:
            PORT.chaos.reset(0)
        assert PORT.obs.flight.recent(4, kind="train.abort")


def test_attach_durable_persists_only_good_steps(tmp_path):
    from paddle_tpu_torch.distributed.durable import CheckpointManager
    with clean_planes({"numerics": False}):
        step = common.port_build_incident_step(seed=0)
        mgr = CheckpointManager(str(tmp_path / "gens"), keep_last=10)
        step.attach_durable(mgr, every=1, mode="sync",
                            arm_preemption=False)
        PORT.chaos.arm("train.step_grads", mode="nan", nth=3, n_times=1,
                       payload_index=1)
        for b in _batches():
            step(*(torch.from_numpy(a) for a in b))
        PORT.chaos.reset(0)
    assert mgr.generations() == [1, 2, 3, 4, 5]
    assert mgr.latest_verified() == 5


def test_membership_changed_snapshots_and_restores_in_place():
    with clean_planes({"numerics": False}):
        step = common.port_build_incident_step(seed=0)
        step(*(torch.from_numpy(a) for a in common.batch()))
        step.membership_changed(epoch=5)
        assert step.membership_epoch == 5 and step.membership_events == 1
        live = dict(step.step.model.named_parameters())
        good = {n: p.detach().clone() for n, p in live.items()}
        ptrs = {n: p.data_ptr() for n, p in live.items()}
        with torch.no_grad():
            for p in live.values():
                p.mul_(0.0)
        step.restore()
        for n, p in step.step.model.named_parameters():
            assert torch.equal(p, good[n]) and p.data_ptr() == ptrs[n]
        assert step.snapshot_bytes() == sum(
            t.numel() * 4 for t in good.values())


def _mlp_batches(n=5, bad=2):
    """``n`` (x, y) batches of 8 rows from a numpy seed; batch ``bad``
    carries a NaN in its first row (rank 0's half at dp = 2)."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        x = rng.standard_normal((8, 6)).astype(np.float32)
        if i == bad:
            x[0, 0] = np.nan
        out.append((x, rng.integers(0, 3, size=(8,)).astype(np.int64)))
    return out


def _reference_stage3():
    """The reference's ResilientTrainStep over its ShardedTrainStep at
    dp = 2, ZeRO stage 3 (2 of the 8 virtual devices), Adam: initial
    weights, losses, skip flags and final parameters."""
    import jax
    import paddle_tpu.nn as jnn
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.framework.resilient import ResilientTrainStep as JRes
    from paddle_tpu.parallel import ShardedTrainStep as JStep
    from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
    paddle.seed(5)
    m = jnn.Sequential(jnn.Linear(6, 16), jnn.Tanh(), jnn.Linear(16, 3))
    init = {n: np.asarray(p._data) for n, p in m.named_parameters()}

    def ce(model, x, y):
        return paddle.nn.functional.cross_entropy(model(x), y).mean()
    prev = get_mesh()
    mesh = set_mesh(make_mesh({"dp": 2}, devices=jax.devices()[:2]))
    try:
        step = JRes(JStep(m, ce, jopt.Adam(learning_rate=1e-2,
                                           parameters=m.parameters()),
                          mesh=mesh, sharding_stage=3))
        losses, skipped = [], []
        for x, y in _mlp_batches():
            losses.append(float(step(paddle.to_tensor(x),
                                     paddle.to_tensor(y))))
            skipped.append(step.last_step_skipped)
    finally:
        set_mesh(prev)
    return init, losses, skipped, {n: np.asarray(p._data)
                                   for n, p in m.named_parameters()}


def _port_stage3(init, wrapped=True, skip=None):
    """The port's ShardedTrainStep at dp = 2, stage 3, on LoopbackWorld
    ranks, wrapped in ResilientTrainStep (or bare, fed the batches
    without ``skip``): each rank's losses, skip flags and gathered
    parameters."""
    from paddle_tpu_torch.framework.resilient import ResilientTrainStep
    from paddle_tpu_torch.models import load_named_params
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep
    batches = [b for i, b in enumerate(_mlp_batches()) if i != skip]

    def ce(model, x, y):
        return torch.nn.functional.cross_entropy(model(x), y)

    def fn(rank, mesh):
        m = load_named_params(torch.nn.Sequential(
            Linear(6, 16, device="cpu"), torch.nn.Tanh(),
            Linear(16, 3, device="cpu")), init)
        step = ShardedTrainStep(m, ce, Adam(learning_rate=1e-2),
                                sharding_stage=3)
        if wrapped:
            step = ResilientTrainStep(step)
        losses, skipped = [], []
        for x, y in batches:
            losses.append(float(step(torch.from_numpy(x),
                                     torch.from_numpy(y))))
            skipped.append(getattr(step, "last_step_skipped", False))
        inner = step.step if wrapped else step
        inner.gather_params()
        return losses, skipped, {n: p.detach().numpy().copy()
                                 for n, p in m.named_parameters()}
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with clean_planes({"numerics": False, "incident": False}):
            return LoopbackWorld(2).run(fn, axes={"dp": 2})
    finally:
        torch.set_num_threads(prev)


def test_stage3_sharded_step_rolls_back_its_chunks():
    """ResilientTrainStep over ShardedTrainStep at dp = 2, ZeRO stage 3
    (parameters held as chunks between calls), the 3rd batch carrying a
    NaN: one skip on both ranks, as the reference's wrapper over its
    stage-3 step; losses and final parameters within 1e-5 of the
    reference's, and bitwise the port's bare stage-3 step fed the same
    batches without the poisoned one (the rollback restored the chunks,
    not only the optimizer state)."""
    init, jl, js, jp = _reference_stage3()
    got = _port_stage3(init)
    plain = _port_stage3(init, wrapped=False, skip=2)
    assert js == [False, False, True, False, False]
    for losses, skipped, params in got:
        assert skipped == js
        assert np.isnan(losses[2])
        np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-6)
        for n in jp:
            np.testing.assert_allclose(params[n], jp[n], rtol=1e-5,
                                       atol=1e-6)
        assert [a for a, s in zip(losses, skipped) if not s] == plain[0][0]
        for n, v in plain[0][2].items():
            assert np.array_equal(params[n], v), n
