"""Floating buffers (BatchNorm's running stats) through the port's
data-parallel steps, on gloo ranks spawned as processes at dp = 2:
``CompressedAllReduceTrainStep`` (f32 wire) and ``ShardedUpdateTrainStep``
(f32 wire) on a small conv + BN model, 3 Momentum steps each.

- each rank normalises its own half of the batch, so its running stats
  differ before the step averages them: after every step both ranks hold
  the same bits;
- f32 ZeRO stays bitwise the replicated step: losses, parameters and the
  averaged running stats;
- both are within 1e-4 (absolute and relative) of the reference's steps
  on its 8-device CPU mesh (dp = 2), from the same weights and buffers
  carried by name.

The JAX imports live in the tests, so the spawned ranks import only torch,
numpy and the port."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import load_named_buffers, load_named_params
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.parallel import init_process_group, make_mesh
from paddle_tpu_torch.parallel.dp_meta import CompressedAllReduceTrainStep
from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep

STEPS = 3
TOL = dict(rtol=1e-4, atol=1e-4)


def _data():
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((8, 3, 6, 6)) + 0.5).astype(np.float32)
    y = rng.standard_normal((8, 1)).astype(np.float32)
    return x, y


def _model(params, buffers):
    m = tnn.Sequential(
        tnn.Conv2D(3, 4, 3, padding=1, bias_attr=False, device="cpu"),
        tnn.BatchNorm2D(4, device="cpu"), tnn.ReLU(), tnn.Flatten(),
        tnn.Linear(4 * 6 * 6, 1, device="cpu"))
    load_named_params(m, params)
    return load_named_buffers(m, buffers)


def _loss_fn(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _run(kind, params, buffers, mesh):
    m = _model(params, buffers)
    opt = Momentum(learning_rate=0.05, momentum=0.9)
    step = (CompressedAllReduceTrainStep(m, _loss_fn, opt, mesh=mesh,
                                         compress_dtype="float32")
            if kind == "replicated" else
            ShardedUpdateTrainStep(m, _loss_fn, opt, mesh=mesh,
                                   wire_dtype="f32", chunk=8))
    x, y = _data()
    out = []
    for _ in range(STEPS):
        loss = float(step(x, y))
        out.append({"loss": loss,
                    "params": {n: p.detach().clone()
                               for n, p in m.named_parameters()},
                    "buffers": {n: b.clone()
                                for n, b in m.named_buffers()}})
    return out


def _worker(rank, weights, init, path):
    torch.set_num_threads(1)
    init_process_group("cpu", rank=rank, world_size=2, init_method=init)
    try:
        mesh = make_mesh({"dp": 2})
        torch.save({k: _run(k, *weights, mesh)
                    for k in ("replicated", "zero")}, f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _reference_model():
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    paddle.seed(0)
    return jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1, bias_attr=False),
                          jnn.BatchNorm2D(4), jnn.ReLU(), jnn.Flatten(),
                          jnn.Linear(4 * 6 * 6, 1))


def _named(pairs):
    return {n: np.array(t._data) for n, t in pairs}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    m = _reference_model()
    weights = (_named(m.named_parameters()), _named(m.named_buffers()))
    d = tmp_path_factory.mktemp("bn_dp2")
    mp.spawn(_worker, args=(weights, f"file://{d}/store", str(d)),
             nprocs=2, join=True)
    return weights, [torch.load(d / f"rank{r}.pt", weights_only=False)
                     for r in range(2)]


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_ranks_hold_the_same_averaged_buffers(ranks):
    _, (r0, r1) = ranks
    for kind in ("replicated", "zero"):
        for s0, s1 in zip(r0[kind], r1[kind]):
            _equal(s0["buffers"], s1["buffers"])
            _equal(s0["params"], s1["params"])
    # rank 0's half alone would have left other running stats
    weights, _ = ranks
    m = _model(*weights)
    m(torch.from_numpy(_data()[0][:4]))
    for n, b in m.named_buffers():
        assert not torch.allclose(b, r0["replicated"][0]["buffers"][n],
                                  atol=1e-3), n


def test_f32_zero_bitwise_replicated_with_buffers(ranks):
    _, (r0, _) = ranks
    for z, r in zip(r0["zero"], r0["replicated"]):
        assert z["loss"] == r["loss"]
        _equal(z["params"], r["params"])
        _equal(z["buffers"], r["buffers"])


@pytest.mark.parametrize("kind", ["replicated", "zero"])
def test_buffers_match_jax_steps(ranks, kind):
    import jax
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel import make_mesh as jmake_mesh
    from paddle_tpu.parallel import set_mesh as jset_mesh
    from paddle_tpu.parallel.dp_meta import (
        CompressedAllReduceTrainStep as JReplicated)
    from paddle_tpu.parallel.zero import ShardedUpdateTrainStep as JZero
    _, (r0, _) = ranks
    m = _reference_model()
    mesh = jmake_mesh({"dp": 2}, devices=jax.devices()[:2])
    jset_mesh(mesh)
    opt = jopt.Momentum(learning_rate=0.05, momentum=0.9,
                        parameters=m.parameters())
    step = (JReplicated(m, _loss_fn, opt, mesh=mesh, compress_dtype="float32")
            if kind == "replicated" else
            JZero(m, _loss_fn, opt, mesh=mesh, wire_dtype="f32", chunk=8))
    x, y = (paddle.to_tensor(a) for a in _data())
    for got in r0[kind]:
        want = float(step(x, y))
        assert abs(got["loss"] - want) <= 1e-5
        for n, b in m.named_buffers():
            np.testing.assert_allclose(got["buffers"][n].numpy(),
                                       np.asarray(b._data), **TOL,
                                       err_msg=n)
        for n, p in m.named_parameters():
            np.testing.assert_allclose(got["params"][n].numpy(),
                                       np.asarray(p._data), **TOL,
                                       err_msg=n)
