"""The port's ShardedTrainStep (paddle_tpu_torch/parallel/sharded.py) and
SyncBatchNorm, held to the reference's ShardedTrainStep on 2- and
4-device sub-meshes of the 8 virtual CPU devices and to one-rank
``TrainStep`` on the global batch.

The port's ranks are ``LoopbackWorld`` threads, each with its own replica
built from the reference's initial weights (``load_named_params``; no
rank draws from a shared generator).  Tolerances: stages 0-3 and every
layout of the same data ranks bitwise to each other, and the ranks'
replicas bitwise equal; against one-rank TrainStep on the global batch
and against the reference 2e-6 (f32 sums in another order, SGD; the
MLP's first loss is bitwise one-rank TrainStep's at dp = 2, the sum of
two halves being the half-sums' sum).  A batch norm normalises by the
global batch's statistics under the sharded step, as GSPMD gives the
reference; a loss divided by a data-dependent count (BERT's masked LM)
is, in the port, the mean of the ranks' losses: the test shows the
gap."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_named_buffers, load_named_params
from paddle_tpu_torch.nn import BatchNorm1D, Linear, SyncBatchNorm
from paddle_tpu_torch.optimizer import SGD, Adam, Lamb
from paddle_tpu_torch.parallel import LoopbackWorld, Mesh, ShardedTrainStep
from paddle_tpu_torch.parallel import shard_module

STEPS = 3
LR = 0.1
TOL = 2e-6


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 16)).astype(np.float32),
            rng.integers(0, 4, size=(n,)).astype(np.int64))


def _ce(m, x, y):
    return torch.nn.functional.cross_entropy(m(x), y)


def _jce(m, x, y):
    import paddle_tpu as paddle
    return paddle.nn.functional.cross_entropy(m(x), y).mean()


def _reference(bn, seed=3):
    """The reference MLP (with a BatchNorm1D when ``bn``) and its weights
    and buffers by name."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    paddle.seed(seed)
    layers = [jnn.Linear(16, 32)] + ([jnn.BatchNorm1D(32)] if bn else []) \
        + [jnn.Tanh(), jnn.Linear(32, 4)]
    m = jnn.Sequential(*layers)
    return (m, {n: np.asarray(p._data) for n, p in m.named_parameters()},
            {n: np.asarray(b._data) for n, b in m.named_buffers()})


def _port(bn, weights, buffers=None, sync=False):
    norm = SyncBatchNorm if sync else BatchNorm1D
    layers = [Linear(16, 32, device="cpu")] + (
        [norm(32, device="cpu")] if bn else []) + [
        torch.nn.Tanh(), Linear(32, 4, device="cpu")]
    m = load_named_params(torch.nn.Sequential(*layers), weights)
    return load_named_buffers(m, buffers) if buffers else m


def _state(m):
    return {n: t.detach().clone() for n, t in m.state_dict().items()}


def _port_run(bn, weights, buffers, axes, n, stage=0, acc=1, steps=STEPS,
              sync=False):
    x, y = _data()

    def fn(rank, mesh):
        m = _port(bn, weights, buffers, sync)
        s = ShardedTrainStep(m, _ce, SGD(learning_rate=LR),
                             sharding_stage=stage, accumulate_steps=acc)
        losses = [float(s(x, y)) for _ in range(steps)]
        s.gather_params()
        return losses, _state(m), s.opt_state_bytes_per_replica()
    return LoopbackWorld(n).run(fn, axes=axes)


def _trainstep_run(bn, weights, buffers, acc=1):
    x, y = _data()
    m = _port(bn, weights, buffers)
    s = TrainStep(m, _ce, SGD(learning_rate=LR), accumulate_steps=acc)
    return [float(s(x, y)) for _ in range(STEPS)], _state(m)


def _jax_run(bn, axes, stage=0, acc=1):
    import jax
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel import ShardedTrainStep as JStep
    from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
    m, _, _ = _reference(bn)
    n = int(np.prod(list(axes.values())))
    prev = get_mesh()
    mesh = set_mesh(make_mesh(axes, devices=jax.devices()[:n]))
    try:
        s = JStep(m, _jce, jopt.SGD(learning_rate=LR,
                                    parameters=m.parameters()),
                  mesh=mesh, sharding_stage=stage, accumulate_steps=acc)
        x, y = _data()
        losses = [float(s(paddle.to_tensor(x), paddle.to_tensor(y)))
                  for _ in range(STEPS)]
    finally:
        set_mesh(prev)
    state = {n: np.asarray(p._data) for n, p in m.named_parameters()}
    state.update({n: np.asarray(b._data) for n, b in m.named_buffers()})
    return losses, state


def _close(a: dict, b: dict, tol=TOL):
    assert a.keys() == b.keys()
    for n in a:
        np.testing.assert_allclose(np.asarray(a[n]), np.asarray(b[n]),
                                   rtol=tol, atol=tol, err_msg=n)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The simulated ranks share the process: one intra-op thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


LAYOUTS = [(("dp", 2), s) for s in range(4)] + [
    (("dp", 2, "sharding", 2), s) for s in range(4)] + [(("sharding", 4), 0)]


@pytest.fixture(scope="module")
def runs():
    """{(bn, acc): (one-rank TrainStep, {(axes, stage): ranks' results})}:
    dp = 2 and dp = 2 x sharding = 2 at every stage, sharding = 4 at 0."""
    out = {}
    for bn, acc in ((False, 1), (True, 1), (True, 2)):
        _, w, b = _reference(bn)
        ranks = {}
        for axes, stage in LAYOUTS:
            shape = dict(zip(axes[::2], axes[1::2]))
            n = int(np.prod(list(shape.values())))
            ranks[(axes, stage)] = _port_run(bn, w, b, shape, n, stage, acc)
        out[(bn, acc)] = (_trainstep_run(bn, w, b, acc), ranks)
    return out


@pytest.mark.parametrize("bn,acc", [(False, 1), (True, 1), (True, 2)])
def test_stages_and_layouts_are_bitwise_one_another(runs, bn, acc):
    """Stages 0-3 on dp=2, dp=2 x sharding=2 and sharding=4: the ranks'
    replicas bitwise equal, and the same four data ranks give the same
    bits whatever the axes and the stage."""
    _, ranks = runs[(bn, acc)]
    for key, got in ranks.items():
        for r in got[1:]:
            assert r[0] == got[0][0], key
            for n in r[1]:
                assert torch.equal(r[1][n], got[0][1][n]), (key, n)
    for axes in (("dp", 2), ("dp", 2, "sharding", 2)):
        base = ranks[(axes, 0)][0]
        for stage in (1, 2, 3):
            got = ranks[(axes, stage)][0]
            assert got[0] == base[0], (axes, stage)
            for n in base[1]:
                assert torch.equal(got[1][n], base[1][n]), (axes, stage, n)
    four = ranks[(("dp", 2, "sharding", 2), 0)][0]
    for n in four[1]:
        assert torch.equal(ranks[(("sharding", 4), 0)][0][1][n], four[1][n])


@pytest.mark.parametrize("bn,acc", [(False, 1), (True, 1), (True, 2)])
def test_matches_one_rank_trainstep_on_the_global_batch(runs, bn, acc):
    """Losses, parameters and (with a batch norm) the running statistics
    within 2e-6 of TrainStep on the global batch, at dp = 2 and 4: the
    batch norm took the global batch's statistics."""
    (want_l, want_s), ranks = runs[(bn, acc)]
    for axes in (("dp", 2), ("sharding", 4)):
        got_l, got_s, _ = ranks[(axes, 0)][0]
        np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
        _close({n: t.numpy() for n, t in got_s.items()},
               {n: t.numpy() for n, t in want_s.items()})
    if not bn and acc == 1:
        assert ranks[(("dp", 2), 0)][0][0][0] == want_l[0]


@pytest.mark.parametrize("bn,acc,axes,stage", [
    (False, 1, ("dp", 2), 0), (False, 1, ("dp", 2, "sharding", 2), 3),
    (True, 1, ("dp", 2), 0), (True, 2, ("dp", 2, "sharding", 2), 2)])
def test_matches_the_reference_sharded_step(runs, bn, acc, axes, stage):
    """The reference's ShardedTrainStep (pjit over the global batch) on the
    same mesh and stage: losses, parameters and buffers within 2e-6."""
    _, ranks = runs[(bn, acc)]
    want_l, want_s = _jax_run(bn, dict(zip(axes[::2], axes[1::2])), stage,
                              acc)
    got_l, got_s, _ = ranks[(axes, stage)][0]
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    _close({n: t.numpy() for n, t in got_s.items()}, want_s)


def test_optimizer_state_is_sharded_by_stage(runs):
    """Stage >= 1 holds about 1/n of the optimizer state on each rank (its
    flat chunk of every parameter): SGD has none, so Adam is measured."""
    _, w, b = _reference(False)
    x, y = _data()

    def fn(rank, mesh):
        out = []
        for stage in (0, 1, 3):
            m = _port(False, w)
            s = ShardedTrainStep(m, _ce, Adam(learning_rate=0.01),
                                 sharding_stage=stage)
            s(x, y)
            out.append(s.opt_state_bytes_per_replica())
            if stage == 3:
                assert all(p.numel() == 0 for p in m.parameters())
                s.gather_params()
                assert [tuple(p.shape) for p in m.parameters()] == [
                    (16, 32), (32,), (32, 4), (4,)]
        return out
    full, one, three = LoopbackWorld(4).run(fn)[0]
    n_params = sum(v.size for v in w.values())
    chunks = sum(-(-v.size // 4) for v in w.values())
    assert full == 2 * 4 * n_params + 4 * 2 * 4     # moments, beta pows
    assert one == three == 2 * 4 * chunks + 4 * 2 * 4


def test_sync_batchnorm_converts_and_follows_the_step(runs):
    """convert_sync_batchnorm swaps every nested batch norm for a
    SyncBatchNorm with the same weight, bias and statistics, as the
    reference's; under the sharded step it trains as the BatchNorm1D
    model does (global statistics), bitwise."""
    import paddle_tpu.nn as jnn
    ref, w, b = _reference(True)
    jnn.SyncBatchNorm.convert_sync_batchnorm(ref)
    inner = torch.nn.Sequential(_port(True, w, b))
    rng = np.random.default_rng(1)
    want = {k: rng.random(32).astype(np.float32)
            for k in ("weight", "bias", "_mean", "_variance")}
    with torch.no_grad():
        for k, v in want.items():
            getattr(inner[0][1], k).copy_(torch.from_numpy(v))
    inner.eval()
    assert SyncBatchNorm.convert_sync_batchnorm(inner) is inner
    bn = inner[0][1]
    assert type(bn) is SyncBatchNorm and not bn.training
    assert type(ref[1]).__name__ == "SyncBatchNorm"
    assert [n for n, _ in inner[0].named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(bn, k).detach().numpy(), v)
    sync = _port_run(True, w, b, {"dp": 2}, 2, sync=True)[0]
    plain = runs[(True, 1)][1][(("dp", 2), 0)][0]
    assert sync[0] == plain[0]
    for n in plain[1]:
        assert torch.equal(sync[1][n], plain[1][n]), n


def test_masked_lm_loss_is_the_mean_of_the_ranks_losses():
    """BERT's masked-LM loss divides by the count of masked positions.
    The reference's sharded step divides by the global batch's count (one
    program over the global batch: its loss is the one-rank loss on the
    global batch); the port's averages the ranks' losses, each over its
    own count.  With the ranks' counts unequal the two differ, by more
    than 1e-3 here: the port's is the mean of the per-slice losses."""
    import jax
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.models import bert as jbert
    from paddle_tpu.parallel import ShardedTrainStep as JStep
    from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
    from paddle_tpu_torch.models import Bert, BertConfig, bert_pretrain_loss
    kw = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=16, remat=False)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (4, 16)).astype(np.int64)
    mlm = np.full((4, 16), -100, np.int64)
    mlm[0, :2] = ids[0, :2]                      # rank 0: 2 + 3 masked
    mlm[1, :3] = ids[1, :3]
    mlm[2:, :8] = ids[2:, :8]                    # rank 1: 16 masked
    nsp = rng.integers(0, 2, (4,)).astype(np.int64)
    ref = jbert.Bert(jbert.BertConfig(**kw))
    weights = {n: np.array(ref._parameters[n]._data)
               for n in jbert._PARAM_ORDER}

    def port_model():
        return Bert(BertConfig(**kw), device="cpu").load_jax_params(weights)

    def fn(rank, mesh):
        s = ShardedTrainStep(port_model(), bert_pretrain_loss,
                             SGD(learning_rate=0.0))
        return float(s(ids, mlm, nsp))
    sharded = LoopbackWorld(2).run(fn)[0]
    m = port_model()
    with torch.no_grad():
        whole = float(bert_pretrain_loss(m, ids, mlm, nsp))
        halves = [float(bert_pretrain_loss(m, ids[i:i + 2], mlm[i:i + 2],
                                           nsp[i:i + 2])) for i in (0, 2)]
    prev = get_mesh()
    mesh = set_mesh(make_mesh({"dp": 2}, devices=jax.devices()[:2]))
    try:
        js = JStep(ref, jbert.bert_pretrain_loss,
                   jopt.SGD(learning_rate=0.0, parameters=ref.parameters()),
                   mesh=mesh)
        jloss = float(js(paddle.to_tensor(ids), paddle.to_tensor(mlm),
                         paddle.to_tensor(nsp)))
    finally:
        set_mesh(prev)
    np.testing.assert_allclose(jloss, whole, rtol=1e-5)
    np.testing.assert_allclose(sharded, np.mean(halves), rtol=1e-6)
    assert abs(sharded - whole) > 1e-3


def test_refusals():
    """A pipeline axis runs (item 3c is ported: the MLP, no stage-aware
    model, trains on a pp x dp mesh as on its dp ranks, each pp rank a
    replica), and so do mp and input_specs (the MLP, with no mp
    annotation, trains on a dp x mp mesh as on its dp ranks, and
    input_specs naming dim 0 over dp is the default layout); a batch that
    does not divide, a sharded Lamb and lower_hlo raise."""
    _, w, _ = _reference(False)
    x, y = _data(n=6)
    xs, ys = _data(n=8)

    def fn(rank, mesh):
        m = _port(False, w)
        piped = ShardedTrainStep(_port(False, w), _ce, SGD(),
                                 mesh=Mesh({"pp": 2, "dp": 2}, mesh.group))
        alone = ShardedTrainStep(_port(False, w), _ce, SGD(),
                                 mesh=Mesh({"dp": 2, "mp": 2}, mesh.group))
        assert float(piped(xs, ys)) == float(alone(xs, ys))
        mixed = ShardedTrainStep(_port(False, w), _ce, SGD(),
                                 mesh=Mesh({"dp": 2, "mp": 2}, mesh.group))
        plain = ShardedTrainStep(_port(False, w), _ce, SGD(),
                                 mesh=Mesh({"dp": 2, "mp": 2}, mesh.group),
                                 input_specs=[("dp",), ("dp",)])
        assert float(mixed(xs, ys)) == float(plain(xs, ys))
        with pytest.raises(TypeError, match="norm-per-parameter"):
            ShardedTrainStep(m, _ce, Lamb(), sharding_stage=1)
        ShardedTrainStep(m, _ce, Lamb(), sharding_stage=0)
        s = ShardedTrainStep(m, _ce, SGD())
        with pytest.raises(ValueError, match="not divisible"):
            s(x, y)
        with pytest.raises(NotImplementedError, match="item 8"):
            s.lower_hlo(x, y)
        shard_module(m, {r"0\.weight": (None, "mp")})
        assert m[0].weight.dist_attr.spec == (None, "mp")
        return True
    assert LoopbackWorld(4).run(fn) == [True] * 4
