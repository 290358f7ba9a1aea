"""GPT's tensor-parallel path (paddle_tpu_torch/models/gpt.py at mp > 1)
under the port's ShardedTrainStep, held to the reference's
ShardedTrainStep on the same meshes of the 8 virtual CPU devices.

A GPT of H = 128, 2 heads of 64, 2 layers, V = 256, S = 256
(``remat=False`` unless said), B = 8, Adam(1e-3), 3 steps.  The port's
ranks are ``LoopbackWorld`` threads; each builds its GPT under the mesh
(holding its shards, ``qkv`` head-aligned) and takes the reference's
initial weights through ``models.shard_params``.  f32: losses and logits
1e-5; the gathered parameters and Adam moments after the steps 1e-4.  The
reference runs once per mesh (module fixture, 6-8 s each on the CPU);
ZeRO stage 2 and ``remat=True`` are held bitwise to the port's stage 0
and ``remat=False`` on the same mesh.  The ``sp`` meshes are in
``test_torch_gpt_hybrid_sp.py`` (one file each keeps a process under
30 s)."""
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
from paddle_tpu_torch.jit import loss_and_grads, loss_closure
from paddle_tpu_torch.models import (GPT, GPTConfig, Bert, bert_tiny,
                                     gpt_loss, shard_params)
from paddle_tpu_torch.models.gpt import _PARAM_ORDER
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByValue, Linear
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.parallel import (LoopbackWorld, Mesh, ShardedTrainStep,
                                       shard_module, tp)

VAL, GRAD = 1e-5, 1e-4
STEPS = 3
CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_seq_len=256)
MESHES = {"dp2_mp2": {"dp": 2, "mp": 2}, "mp2": {"mp": 2}}


def _ids():
    return np.random.default_rng(1).integers(0, 256, (8, 256)).astype(
        np.int64)


def reference_run(axes, logits=False):
    """The reference's 3 Adam steps on ``axes``: initial parameters,
    losses, final parameters, moments, and (when asked) its logits before
    training."""
    model = JGPT(JConfig(remat=False, **CFG))
    init = {n: np.asarray(model._parameters[n]._data) for n in _PARAM_ORDER}
    ids = paddle.to_tensor(_ids())
    if logits:          # one global array whatever the mesh: take it whole
        jset_mesh(jmake_mesh({"dp": 1}))
        logits = np.asarray(model(ids)._data)
    mesh = jset_mesh(jmake_mesh(axes))
    step = JStep(model, jgpt_loss, jopt.Adam(
        learning_rate=1e-3, parameters=model.parameters()), mesh=mesh)
    losses = [float(step(ids, ids)) for _ in range(STEPS)]
    final = {n: np.asarray(model._parameters[n]._data) for n in _PARAM_ORDER}
    moments = {n: {k: np.asarray(st[k]) for k in ("moment1", "moment2")}
               for n, st in step._opt_states.items()}
    return init, losses, final, moments, logits


@pytest.fixture(scope="module")
def reference():
    return {name: reference_run(axes, logits=name == "mp2")
            for name, axes in MESHES.items()}


@pytest.fixture
def deterministic():
    """Bitwise comparisons of two runs: the CPU's embedding backward
    (``index_put_`` with accumulate) otherwise sums in thread order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _full(t, p, mesh):
    """A rank's shard-shaped tensor of parameter p as the full one."""
    split = getattr(p, "mp_split", None)
    if split is None:
        return t
    return split[0].assemble(mesh.axis_group("mp").all_gather(
        t.contiguous()).unbind(0))


def port_run(axes, init, stage=0, remat=False, steps=STEPS):
    """The port's steps on LoopbackWorld ranks laid out as ``axes``: rank
    0's losses, gathered parameters and (stage 0) moments; every rank's
    losses."""
    n = int(np.prod(list(axes.values())))
    ids = torch.from_numpy(_ids())

    def fn(rank, mesh):
        model = GPT(GPTConfig(remat=remat, **CFG), device="cpu", mesh=mesh)
        shards = shard_params(init, mesh.shape.get("mp", 1),
                              mesh.axis_index("mp"))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(shards[name])
        step = ShardedTrainStep(model, gpt_loss, Adam(learning_rate=1e-3),
                                mesh=mesh, sharding_stage=stage)
        losses = [float(step(ids, ids)) for _ in range(steps)]
        full = {k: v.numpy() for k, v in step.gather_params().items()}
        moments = None
        if stage == 0:
            named = dict(model.named_parameters())
            moments = {k: {m: _full(st[m], named[k], mesh).numpy()
                           for m in ("moment1", "moment2")}
                       for k, st in step._opt_states.items()}
        return losses, full, moments, step.opt_state_bytes_per_replica()
    return LoopbackWorld(n).run(fn, axes=axes)


def _close_rel(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mp_steps_match_reference(reference, mesh):
    """3 Adam steps at mp = 2 (with dp = 2 and alone): the losses, the
    gathered parameters and the moments as the reference's step on the
    same mesh; every rank reads the same losses."""
    init, want_l, want_p, want_m, _ = reference[mesh]
    got = port_run(MESHES[mesh], init)
    losses, params, moments, _ = got[0]
    np.testing.assert_allclose(losses, want_l, rtol=VAL, atol=VAL)
    for n, v in want_p.items():
        np.testing.assert_allclose(params[n], v, rtol=GRAD, atol=GRAD)
        for m in ("moment1", "moment2"):
            _close_rel(moments[n][m], want_m[n][m], GRAD)
    assert all(r[0] == losses for r in got)


def test_zero_stage2_with_mp(reference, deterministic):
    """ZeRO stage 2 on {"dp": 2, "mp": 2} chunks each rank's mp shard over
    dp: losses and gathered parameters bitwise stage 0's, each rank's
    optimizer state half of stage 0's."""
    init = reference["dp2_mp2"][0]
    base = port_run(MESHES["dp2_mp2"], init)
    zero = port_run(MESHES["dp2_mp2"], init, stage=2)
    for b, z in zip(base, zero):
        assert b[0] == z[0]
        for n in b[1]:
            assert np.array_equal(b[1][n], z[1][n]), n
        assert z[3] < 0.55 * b[3]


def test_remat_at_mp2(reference, deterministic):
    """remat=True at mp = 2 replays each layer's collectives in the
    backward (on the CPU the ranks' own threads): bitwise remat=False's
    run, and so the reference's."""
    init, want_l = reference["mp2"][:2]
    plain = port_run(MESHES["mp2"], init, steps=2)
    remat = port_run(MESHES["mp2"], init, remat=True, steps=2)
    np.testing.assert_allclose(remat[0][0], want_l[:2], rtol=VAL, atol=VAL)
    for p, r in zip(plain, remat):
        assert p[0] == r[0]
        for n in p[1]:
            assert np.array_equal(p[1][n], r[1][n]), n


def _serve(init, axes, fault=False):
    ids = torch.from_numpy(_ids())

    def fn(rank, mesh):
        model = GPT(GPTConfig(**CFG), device="cpu", mesh=mesh)
        model.load_jax_params(init)
        if fault:
            with torch.no_grad():
                for name in ("qkv_w", "qkv_b"):
                    p = getattr(model, name)
                    split, n, idx = p.mp_split
                    p.copy_(tp.Split(split.dim).take(
                        torch.tensor(init[name]), n, idx))
        with torch.inference_mode():
            return model(ids).numpy(), float(gpt_loss(model, ids, ids))
    return LoopbackWorld(int(np.prod(list(axes.values())))).run(fn, axes=axes)


def test_serving_logits_mp2(reference):
    """GPT.forward at mp = 2 all-gathers the reference's (B, S, V) logits
    on every rank, the loss its first loss; a qkv shard cut contiguously
    (rank 0 all of q and half of k) is far off."""
    init, want_l, _, _, logits = reference["mp2"]
    got = _serve(init, MESHES["mp2"])
    for lg, loss in got:
        np.testing.assert_allclose(lg, logits, rtol=VAL, atol=VAL)
        np.testing.assert_allclose(loss, want_l[0], rtol=VAL, atol=VAL)
    bad = _serve(init, MESHES["mp2"], fault=True)[0][0]
    assert np.abs(bad - logits).max() > 1e3 * VAL


@pytest.mark.parametrize("axes", [{"mp": 2}, {"dp": 2, "mp": 2}],
                         ids=["mp2", "dp2_mp2"])
def test_replicated_grads_bitwise_over_mp(reference, axes):
    """A replicated parameter's gradient is the same bits on every mp rank
    (the sums inside the model run in rank order); a split one's differs
    as its shard does."""
    init = reference["mp2"][0]
    ids = torch.from_numpy(_ids())

    def fn(rank, mesh):
        model = GPT(GPTConfig(**CFG), device="cpu", mesh=mesh)
        model.load_jax_params(init)
        params = dict(model.named_parameters())
        nd = mesh.shape.get("dp", 1)
        b = ids.shape[0] // nd
        part = ids[mesh.axis_index("dp") * b:][:b] if nd > 1 else ids
        _, grads = loss_and_grads(loss_closure(model, gpt_loss), params,
                                  [part, part])
        return {n: g for n, g in grads.items()}, \
            {n: hasattr(p, "mp_split") for n, p in params.items()}
    got = LoopbackWorld(int(np.prod(list(axes.values())))).run(fn, axes=axes)
    mp = axes["mp"]
    for start in range(0, len(got), mp):
        group = got[start:start + mp]
        split = group[0][1]
        for n, g in group[0][0].items():
            same = all(torch.equal(g, r[0][n]) for r in group[1:])
            assert same != split[n], n


def test_dist_attr_specs_match_reference():
    """Every GPT parameter carries the reference's DistAttr spec, name by
    name (None where the reference attaches none)."""
    ref = JGPT(JConfig(**CFG))
    port = GPT(GPTConfig(**CFG), device="cpu")
    for n in _PARAM_ORDER:
        want = getattr(ref._parameters[n], "dist_attr", None)
        got = getattr(getattr(port, n), "dist_attr", None)
        assert (None if want is None else tuple(want.spec)) == \
            (None if got is None else got.spec), n


def test_refusals():
    """A parameter split over mp by its DistAttr that no mp-aware layer
    holds in shards raises naming it (a plain Linear under shard_module
    rules), while BERT's are held in shards (item 3d: the step builds,
    each rank holding half the vocabulary); a pipeline axis now runs
    (item 3c: GPT holds its stage's layer), with a clip by value only
    (a global norm would be taken over one stage); heads that do not
    divide over mp raise, as layers that do not divide over pp do."""
    def fn(rank, mesh):
        lin = shard_module(torch.nn.Sequential(Linear(4, 4, device="cpu")),
                           {r"0\.weight": (None, "mp")})
        with pytest.raises(NotImplementedError, match="0.weight"):
            ShardedTrainStep(lin, lambda m, x: m(x).sum(), SGD(), mesh=mesh)
        bert = Bert(bert_tiny(), device="cpu")
        ShardedTrainStep(bert, lambda m, x: x, SGD(), mesh=mesh)
        assert tuple(bert.wte.shape) == (128, 64)
        with pytest.raises(ValueError, match="num_heads=3"):
            GPT(GPTConfig(vocab_size=64, hidden_size=48, num_layers=1,
                          num_heads=3, max_seq_len=16), device="cpu",
                mesh=mesh)
        return True
    assert LoopbackWorld(2).run(fn, axes={"mp": 2}) == [True] * 2

    def pp(rank, mesh):
        model = GPT(GPTConfig(**CFG), device="cpu").apply_mesh(
            Mesh({"pp": 2}, mesh.group))
        with pytest.raises(ValueError, match="num_layers=3"):
            GPT(GPTConfig(**dict(CFG, num_layers=3)), device="cpu"
                ).apply_mesh(Mesh({"pp": 2}, mesh.group))
        with pytest.raises(NotImplementedError,
                           match="ClipGradByGlobalNorm at mp=1, pp=2"):
            ShardedTrainStep(model, gpt_loss, SGD(
                grad_clip=ClipGradByGlobalNorm(1.0)), mesh=model._mesh)
        ShardedTrainStep(model, gpt_loss, SGD(grad_clip=ClipGradByValue(
            1.0)), mesh=model._mesh)
        return tuple(model.qkv_w.shape), model.qkv_w.pp_split
    assert LoopbackWorld(2).run(pp) == [((1, 128, 384), (2, r))
                                        for r in range(2)]
