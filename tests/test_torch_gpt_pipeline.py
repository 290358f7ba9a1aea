"""GPT's pipeline path (paddle_tpu_torch/models/gpt.py at pp > 1) under
the port's ShardedTrainStep, held to the reference's ShardedTrainStep on
the same meshes of the 8 virtual CPU devices.

``test_torch_gpt_hybrid.py``'s GPT (H = 128, 2 heads of 64, 2 layers, V =
256, S = 256, f32, ``remat=False``), ``n_microbatches=2``, B = 8, Adam
(1e-3), ``sharding_stage=1``, 3 steps, at ``{"pp": 2}`` in schedule_mode
0 (F-then-B) and 1 (1F1B), and at ``{"pp": 2, "mp": 2}`` in mode 1 (each
stage's layer on the mp path, the head's vocabulary-parallel CE on the
last stage).  The port's ranks are ``LoopbackWorld``
threads; each builds its GPT under the mesh (one layer a stage, its mp
shards) and takes the reference's initial weights through
``models.shard_params``.  Losses and logits 1e-5; the gathered parameters
and Adam moments 1e-4.  The reference runs once per mesh and mode
(module fixture, 6-9 s each on the CPU); the dp and sp meshes are in
``test_torch_gpt_pipeline_hybrid.py``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import gpt_loss as jgpt_loss
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.parallel.mesh import set_mesh as jset_mesh
from paddle_tpu.parallel.sharded import ShardedTrainStep as JStep
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss, shard_params
from paddle_tpu_torch.models.gpt import _PARAM_ORDER
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep
from paddle_tpu_torch.parallel import pipeline
from paddle_tpu_torch.parallel.pipeline import full_stages
from paddle_tpu_torch.parallel.zero import f32_all_gather

from test_torch_gpt_hybrid import CFG, GRAD, STEPS, VAL, _close_rel, _ids

RUNS = {"pp2_mode0": ({"pp": 2}, 0), "pp2_mode1": ({"pp": 2}, 1),
        "pp2_mp2_mode1": ({"pp": 2, "mp": 2}, 1)}


def reference_run(axes, mode, logits=False):
    """The reference's 3 Adam steps (sharding stage 1) on ``axes`` in
    ``mode``: initial parameters, losses, final parameters, moments and
    (when asked) its logits before training."""
    model = JGPT(JConfig(remat=False, n_microbatches=2, schedule_mode=mode,
                         **CFG))
    init = {n: np.asarray(model._parameters[n]._data) for n in _PARAM_ORDER}
    ids = paddle.to_tensor(_ids())
    if logits:
        jset_mesh(jmake_mesh({"dp": 1}))
        logits = np.asarray(model(ids)._data)
    mesh = jset_mesh(jmake_mesh(axes))
    step = JStep(model, jgpt_loss, jopt.Adam(
        learning_rate=1e-3, parameters=model.parameters()), mesh=mesh,
        sharding_stage=1)
    losses = [float(step(ids, ids)) for _ in range(STEPS)]
    final = {n: np.asarray(model._parameters[n]._data) for n in _PARAM_ORDER}
    moments = {n: {k: np.asarray(st[k]) for k in ("moment1", "moment2")}
               for n, st in step._opt_states.items()}
    return init, losses, final, moments, logits


@pytest.fixture(scope="module")
def reference():
    return {name: reference_run(axes, mode, logits=name == "pp2_mode0")
            for name, (axes, mode) in RUNS.items()}


@pytest.fixture
def deterministic():
    """Bitwise comparisons of two runs: the CPU's embedding backward
    (``index_put_`` with accumulate) otherwise sums in thread order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def build(mesh, init, mode, remat=False, n_microbatches=2):
    """This rank's GPT under ``mesh``, holding its stage and mp shards of
    the reference's ``init``."""
    model = GPT(GPTConfig(remat=remat, n_microbatches=n_microbatches,
                          schedule_mode=mode, **CFG), device="cpu",
                mesh=mesh)
    part = shard_params(init, mesh.shape.get("mp", 1), mesh.axis_index("mp"),
                        pp=mesh.shape.get("pp", 1),
                        stage=mesh.axis_index("pp"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(part[name])
    return model


def gathered_moments(step, model, mesh) -> dict:
    """The step's Adam moments in the reference's full layout: stage 1's
    chunks all-gathered over the ZeRO group, the mp shards assembled, the
    stages concatenated (every rank calls it)."""
    named = dict(model.named_parameters())
    out = {}
    for k in ("moment1", "moment2"):
        full = {}
        for n, st in step._opt_states.items():
            t = st[k]
            if step.sharding_stage >= 1:
                t = f32_all_gather(t, step._zgroup)[:step._specs[n].size]
            t = t.reshape(named[n].shape)
            split = getattr(named[n], "mp_split", None)
            if split is not None:
                t = split[0].assemble(mesh.axis_group("mp").all_gather(
                    t.contiguous()).unbind(0))
            full[n] = t
        if mesh.shape.get("pp", 1) > 1:
            full = full_stages(model, full, mesh.axis_group("pp"))
        for n, t in full.items():
            out.setdefault(n, {})[k] = t.numpy()
    return out


def port_run(axes, init, mode, stage=1, remat=False, steps=STEPS):
    """The port's steps on LoopbackWorld ranks laid out as ``axes``: each
    rank's (losses, gathered parameters, gathered moments, the peak of its
    live microbatch graphs)."""
    n = int(np.prod(list(axes.values())))
    ids = torch.from_numpy(_ids())

    def fn(rank, mesh):
        model = build(mesh, init, mode, remat)
        step = ShardedTrainStep(model, gpt_loss, Adam(learning_rate=1e-3),
                                mesh=mesh, sharding_stage=stage)
        pipeline.reset_live_graphs()
        losses = [float(step(ids, ids)) for _ in range(steps)]
        peak = pipeline.peak_live_graphs()
        full = {k: v.numpy() for k, v in step.gather_params().items()}
        return losses, full, gathered_moments(step, model, mesh), peak
    return LoopbackWorld(n).run(fn, axes=axes)


def check_run(got, want, axes, mode):
    """Rank 0's losses, gathered parameters and moments against the
    reference's ``want``; every rank's losses bitwise rank 0's; the peak
    of the live microbatch graphs by stage (M = 2: under 1F1B 2 on stage
    0 and 1 on stage 1, under F-then-B both)."""
    _, want_l, want_p, want_m, _ = want
    losses, params, moments, _ = got[0]
    np.testing.assert_allclose(losses, want_l, rtol=VAL, atol=VAL)
    for n, v in want_p.items():
        np.testing.assert_allclose(params[n], v, rtol=GRAD, atol=GRAD)
        for m in ("moment1", "moment2"):
            _close_rel(moments[n][m], want_m[n][m], GRAD)
    assert all(r[0] == losses for r in got)
    inner = int(np.prod([s for a, s in axes.items() if a != "pp"]))
    peaks = [r[3] for r in got]
    assert peaks == ([2] * inner + [1] * inner if mode == 1
                     else [2] * 2 * inner)


@pytest.mark.parametrize("run", list(RUNS))
def test_pp_steps_match_reference(reference, run):
    """3 Adam steps at pp = 2, F-then-B and 1F1B, and at pp x mp in 1F1B:
    the losses, the gathered parameters and the moments as the
    reference's step on the same mesh and mode, by ``check_run``."""
    axes, mode = RUNS[run]
    check_run(port_run(axes, reference[run][0], mode), reference[run],
              axes, mode)


def _serve(init, axes, mode):
    ids = torch.from_numpy(_ids())

    def fn(rank, mesh):
        model = GPT(GPTConfig(schedule_mode=mode, n_microbatches=2, **CFG),
                    device="cpu", mesh=mesh)
        model.load_jax_params(init)
        with torch.inference_mode():
            return model(ids).numpy(), float(gpt_loss(model, ids, ids))
    return LoopbackWorld(int(np.prod(list(axes.values())))).run(fn, axes=axes)


@pytest.mark.parametrize("mode", [0, 1])
def test_serving_logits_pp2(reference, mode):
    """GPT.forward at pp = 2 gives every stage the reference's (B, S, V)
    logits (bitwise equal over pp), gpt_loss its first loss (the 1F1B
    program's evaluation under mode 1); load_jax_params takes the
    stage's layers."""
    init, want_l, _, _, logits = reference["pp2_mode0"]
    got = _serve(init, {"pp": 2}, mode)
    np.testing.assert_allclose(got[0][0], logits, rtol=VAL, atol=VAL)
    np.testing.assert_allclose(got[0][1], want_l[0], rtol=VAL, atol=VAL)
    assert np.array_equal(got[0][0], got[1][0]) and got[0][1] == got[1][1]


@pytest.mark.parametrize("mode", [0, 1])
def test_remat_at_pp2(reference, deterministic, mode):
    """remat=True at pp = 2 (no mp or sp: a layer's replay holds no
    collective) gives remat=False's bits, one step in each schedule."""
    init = reference["pp2_mode0"][0]
    plain = port_run({"pp": 2}, init, mode, steps=1)
    remat = port_run({"pp": 2}, init, mode, remat=True, steps=1)
    for p, r in zip(plain, remat):
        assert p[0] == r[0]
        for n in p[1]:
            assert np.array_equal(p[1][n], r[1][n]), n


def test_pipeline_configs_schedule_mode_propagates(reference):
    """fleet with pp_degree 2 and pipeline_configs {"schedule_mode":
    "1F1B"} builds a ShardedTrainStep over {"pp": 2} that sets the
    model's schedule_mode to 1, "F-then-B" to 0 (the reference's
    test_pipeline_configs_schedule_mode_propagates); the step trains to
    the reference's first loss."""
    init, want_l = reference["pp2_mode1"][:2]
    ids = torch.from_numpy(_ids())

    def fn(rank, mesh):
        s = fleet.DistributedStrategy()
        s.pipeline = True
        s.hybrid_configs = {"pp_degree": 2}
        got = []
        for name in ("1F1B", "F-then-B"):
            s.pipeline_configs = {"schedule_mode": name}
            fleet.init(is_collective=True, strategy=s)
            model = GPT(GPTConfig(n_microbatches=2, remat=False, **CFG),
                        device="cpu").load_jax_params(init)
            fleet.distributed_optimizer(Adam(learning_rate=1e-3))
            step = fleet.train_step(model, gpt_loss)
            got.append((type(step).__name__, dict(step.mesh.shape),
                        model.config.schedule_mode, float(step(ids, ids))))
        return got
    for got in LoopbackWorld(2).run(fn):
        assert [g[:3] for g in got] == [
            ("ShardedTrainStep", {"pp": 2}, 1),
            ("ShardedTrainStep", {"pp": 2}, 0)]
        for g in got:
            np.testing.assert_allclose(g[3], want_l[0], rtol=VAL, atol=VAL)


def test_zero_stages_at_dp2_pp2(reference, deterministic):
    """ZeRO stages 0, 2 and 3 at dp = 2 x pp = 2 chunk each rank's stage
    over dp: one step's loss and gathered parameters bitwise stage 1's,
    in 1F1B."""
    init = reference["pp2_mode0"][0]
    axes = {"dp": 2, "pp": 2}
    base = port_run(axes, init, 1, steps=1)
    for stage in (0, 2, 3):
        got = port_run(axes, init, 1, stage=stage, steps=1)
        for b, z in zip(base, got):
            assert b[0] == z[0], stage
            for n in b[1]:
                assert np.array_equal(b[1][n], z[1][n]), (stage, n)
