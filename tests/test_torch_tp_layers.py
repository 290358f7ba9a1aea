"""The port's tensor-parallel layers (paddle_tpu_torch/distributed/
tp_layers.py, parallel/tp.py), ``split``, ``shard_map_compat`` and the
converters' head-aligned ``qkv`` cut, held to the reference.

The reference's layers are dense layers with an ``mp`` annotation: run
eagerly they are the plain layer, and under its ``ShardedTrainStep`` on
the 8-device CPU mesh GSPMD partitions them.  The port's ranks are
``LoopbackWorld`` threads, each holding only its slice of a split
parameter, loaded from the reference's full arrays by
``load_named_params``.  f32 throughout: values 1e-5, gradients and
parameters after steps 1e-4."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import optimizer as jopt
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.parallel.mesh import set_mesh as jset_mesh
from paddle_tpu.parallel.sharded import ShardedTrainStep as JStep
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.models import (GPTConfig, full_opt_states, full_params,
                                     load_named_params, shard_opt_states,
                                     shard_params)
from paddle_tpu_torch.models.gpt import MP_SPLITS, init_params
from paddle_tpu_torch.nn import Layer
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.parallel import (LoopbackWorld, ShardedTrainStep,
                                       shard_map_compat, tp)
from paddle_tpu_torch.parallel.mesh import constrain, set_mesh

VAL, GRAD = 1e-5, 1e-4


def _np(t):
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _rng(seed):
    return np.random.default_rng(seed)


def _ref_run(layer, x, cot, x_grad=True):
    """The reference layer's eager output and the gradients of
    sum(out * cot): x's (when float) and each parameter's, by name."""
    xt = paddle.to_tensor(x, stop_gradient=not x_grad)
    y = layer(xt)
    (y * paddle.to_tensor(cot)).sum().backward()
    grads = {n: _np(p.grad) for n, p in layer.named_parameters()}
    return _np(y), (_np(xt.grad) if x_grad else None), grads


def _weights(layer):
    return {n: _np(p) for n, p in layer.named_parameters()}


def _port_run(make, weights, x, cot, n, out_slice=None, x_grad=True):
    """Each of n ranks (mesh {"mp": n}) builds the layer, loads the full
    weights, runs sum(out * cot) forward and backward.  Returns per rank
    (out, x's gradient, the full gradients by name)."""
    def fn(rank, mesh):
        layer = load_named_params(make(), weights)
        xt = torch.from_numpy(x)
        if x_grad:
            xt.requires_grad_()
        y = layer(xt)
        c = torch.from_numpy(cot)
        if out_slice is not None:
            c = out_slice(c, rank)
        (y * c).sum().backward()
        grads = {}
        for name, p in layer.named_parameters():
            split = getattr(p, "mp_split", None)
            g = p.grad
            if split is not None:
                g = split[0].assemble(
                    mesh.axis_group("mp").all_gather(g).unbind(0))
            grads[name] = g.numpy()
        return (y.detach().numpy(), xt.grad.numpy() if x_grad else None,
                grads)
    return LoopbackWorld(n).run(fn, axes={"mp": n})


def _cols(t, rank, n):
    w = t.shape[-1] // n
    return t[..., rank * w:(rank + 1) * w]


def _check(got, want_y, want_x, want_g, slice_out=None):
    for rank, (y, gx, g) in enumerate(got):
        wy = want_y if slice_out is None else slice_out(want_y, rank)
        np.testing.assert_allclose(y, wy, rtol=VAL, atol=VAL)
        if want_x is not None:
            np.testing.assert_allclose(gx, want_x, rtol=GRAD, atol=GRAD)
        for name, v in want_g.items():
            np.testing.assert_allclose(g[name], v, rtol=GRAD, atol=GRAD)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(n, gather):
    """Each rank's output (gathered, or its columns) and the gradients of
    x, W and b (the rank's slices assembled) as the reference's dense
    layer gives them."""
    paddle.seed(3)
    ref = jdist.ColumnParallelLinear(16, 32, gather_output=gather)
    x = _rng(0).standard_normal((4, 16)).astype(np.float32)
    cot = _rng(1).standard_normal((4, 32)).astype(np.float32)
    want = _ref_run(ref, x, cot)
    cut = None if gather else (lambda t, r: _cols(t, r, n))
    got = _port_run(lambda: dist.ColumnParallelLinear(
        16, 32, gather_output=gather, device="cpu"), _weights(ref), x, cot,
        n, cut)
    _check(got, *want, slice_out=cut)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("parallel_in", [True, False])
def test_row_parallel_linear(n, parallel_in):
    """The rank's rows of W; x split on its last dim (given so, or taken
    by the layer), the partial products summed over mp before the
    replicated bias: output and gradients as the reference's."""
    paddle.seed(4)
    ref = jdist.RowParallelLinear(32, 8, input_is_parallel=parallel_in)
    x = _rng(2).standard_normal((4, 32)).astype(np.float32)
    cot = _rng(3).standard_normal((4, 8)).astype(np.float32)
    want_y, want_x, want_g = _ref_run(ref, x, cot)
    weights = _weights(ref)

    def fn(rank, mesh):
        layer = load_named_params(dist.RowParallelLinear(
            32, 8, input_is_parallel=parallel_in, device="cpu"), weights)
        xt = torch.from_numpy(_cols(x, rank, n) if parallel_in else x)
        xt.requires_grad_()
        (layer(xt) * torch.from_numpy(cot)).sum().backward()
        gw = layer.weight.mp_split[0].assemble(mesh.axis_group(
            "mp").all_gather(layer.weight.grad).unbind(0))
        y = layer(xt).detach().numpy()
        return y, xt.grad.numpy(), {"weight": gw.numpy(),
                                    "bias": layer.bias.grad.numpy()}
    got = LoopbackWorld(n).run(fn, axes={"mp": n})
    for rank, (y, gx, g) in enumerate(got):
        np.testing.assert_allclose(y, want_y, rtol=VAL, atol=VAL)
        np.testing.assert_allclose(
            gx, _cols(want_x, rank, n) if parallel_in else want_x,
            rtol=GRAD, atol=GRAD)
        for name, v in want_g.items():
            np.testing.assert_allclose(g[name], v, rtol=GRAD, atol=GRAD)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("padding_idx", [None, 3])
def test_vocab_parallel_embedding(n, padding_idx):
    """Ids in every rank's range: the masked local lookups summed over mp
    are the reference's rows, padding_idx reads 0 and its row takes no
    gradient."""
    paddle.seed(5)
    ref = jdist.VocabParallelEmbedding(40, 8, padding_idx=padding_idx)
    ids = np.array([[0, 3, 9, 10], [19, 20, 29, 30], [39, 3, 25, 11]],
                   np.int64)
    cot = _rng(4).standard_normal((3, 4, 8)).astype(np.float32)
    want = _ref_run(ref, ids, cot, x_grad=False)
    got = _port_run(lambda: dist.VocabParallelEmbedding(
        40, 8, padding_idx=padding_idx, device="cpu"), _weights(ref), ids,
        cot, n, x_grad=False)
    _check(got, *want)
    if padding_idx is not None:
        assert not got[0][0][0, 1].any()
        assert not got[0][2]["weight"][padding_idx].any()


def test_split_builds_the_layers():
    """``split``: axis 1 / -1 the column layer, another axis the row layer,
    "embedding" the vocabulary layer, each holding its rank's slice and
    giving the plain layer's output from the full weights; applied when
    given a tensor; another operation raises."""
    x = torch.from_numpy(_rng(6).standard_normal((3, 8)).astype(np.float32))
    ids = torch.tensor([[0, 7, 15]])

    def fn(rank, mesh):
        from paddle_tpu_torch import device as tdevice
        tdevice.set_device("cpu")
        out = {}
        for what, args, kind, inp in (
                ("col", ((8, 6), "linear", 1), "ColumnParallelLinear", x),
                ("col_neg", ((8, 6), "linear", -1), "ColumnParallelLinear",
                 x),
                ("row", ((8, 6), "linear", 0), "RowParallelLinear", x),
                ("emb", ((16, 4), "embedding"), "VocabParallelEmbedding",
                 ids)):
            layer = dist.split(None, *args)
            assert type(layer).__name__ == kind
            full = tp.full_parameters(layer, mesh.axis_group("mp"))
            y = layer(inp)
            if what == "emb":
                want = full["weight"][inp]
            else:
                want = inp @ full["weight"] + full["bias"]
            out[what] = float((y - want).detach().abs().max())
            assert dist.split(inp, *args).shape == y.shape
        with pytest.raises(ValueError, match="unsupported split"):
            dist.split(x, (8, 6), "conv")
        return out
    from paddle_tpu_torch import device as tdevice
    was = tdevice.get_device()
    try:
        got = LoopbackWorld(2).run(fn, axes={"mp": 2})
    finally:
        tdevice._default = was
    for errs in got:
        assert max(errs.values()) < VAL, errs


class _JTPBlock(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.col = jdist.ColumnParallelLinear(16, 32, gather_output=False)
        self.row = jdist.RowParallelLinear(32, 4, input_is_parallel=True)

    def forward(self, x):
        return self.row(self.col(x))


class _TPBlock(Layer):
    def __init__(self):
        super().__init__()
        self.col = dist.ColumnParallelLinear(16, 32, gather_output=False,
                                             device="cpu")
        self.row = dist.RowParallelLinear(32, 4, input_is_parallel=True,
                                          device="cpu")

    def forward(self, x):
        return self.row(self.col(x))


def _jce(m, x, y):
    return paddle.nn.functional.cross_entropy(m(x), y).mean()


def _ce(m, x, y):
    return torch.nn.functional.cross_entropy(m(x), y)


@pytest.fixture(scope="module")
def tpblock_reference():
    """The reference's TPBlock under its ShardedTrainStep on {"dp": 2,
    "mp": 4} (tests/test_distributed.py:293-327), 2 SGD steps: initial
    weights, losses, final weights."""
    mesh = jmake_mesh({"dp": 2, "mp": 4})
    jset_mesh(mesh)
    paddle.seed(11)
    ref = _JTPBlock()
    init = _weights(ref)
    x = _rng(2).standard_normal((8, 16)).astype(np.float32)
    y = _rng(2).integers(0, 4, size=(8,)).astype(np.int64)
    step = JStep(ref, _jce, jopt.SGD(learning_rate=0.05,
                                     parameters=ref.parameters()), mesh=mesh)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(2)]
    return init, x, y, losses, _weights(ref)


@pytest.mark.parametrize("specs", [None, [("dp",), ("dp",)]],
                         ids=["default", "input_specs"])
def test_tpblock_sharded_step(tpblock_reference, specs):
    """The port's TPBlock on eight LoopbackWorld ranks, {"dp": 2, "mp": 4}:
    two SGD steps' losses and the gathered weights as the reference's;
    input_specs naming dim 0 over dp gives the default layout's bits."""
    init, x, y, want_l, want_w = tpblock_reference

    def fn(rank, mesh):
        set_mesh(mesh)
        m = load_named_params(_TPBlock(), init)
        step = ShardedTrainStep(m, _ce, SGD(learning_rate=0.05), mesh=mesh,
                                input_specs=specs)
        losses = [float(step(x, y)) for _ in range(2)]
        return losses, {n: t.numpy() for n, t in step.gather_params().items()}
    got = LoopbackWorld(8).run(fn, axes={"dp": 2, "mp": 4})
    for losses, w in got:
        np.testing.assert_allclose(losses, want_l, rtol=VAL, atol=VAL)
        for n, v in want_w.items():
            np.testing.assert_allclose(w[n], v, rtol=GRAD, atol=GRAD)
        assert losses == got[0][0]


def test_shard_map_compat():
    """The reference's multi-axis broadcast (tests/test_distributed.py:
    145-152): x (8, 1) split over ("dp", "mp") of {"dp": 2, "mp": 4},
    broadcast from rank 5, assembled back; a spec splitting dim 1 and a
    tuple output; constrain checks its spec's rank and returns its
    input."""
    x = torch.arange(8.0).reshape(8, 1)
    m = torch.arange(24.0).reshape(4, 6)

    def fn(rank, mesh):
        set_mesh(mesh)
        bcast = shard_map_compat(lambda t: dist.broadcast(t, src=5), mesh,
                                 ((("dp", "mp"),),), (("dp", "mp"),))
        pair = shard_map_compat(lambda t: (t * 2, t.sum(0, keepdim=True)),
                                mesh, ((None, "dp"),),
                                ((None, "dp"), (None, "dp")))
        assert constrain(x, "dp", "mp") is x
        with pytest.raises(ValueError, match="rank"):
            constrain(x, "dp", None, "mp")
        return bcast(x), pair(m)
    got = LoopbackWorld(8).run(fn, axes={"dp": 2, "mp": 4})
    for b, (twice, sums) in got:
        assert torch.equal(b, torch.full((8, 1), 5.0))
        assert torch.equal(twice, m * 2)
        assert torch.equal(sums, m.sum(0, keepdim=True))


@pytest.mark.parametrize("n", [2, 4])
def test_qkv_head_aligned_round_trip(n):
    """GPT's full parameters and Adam state cut into n mp shards (qkv
    head-aligned: rank r holds heads [r nh/n, (r + 1) nh/n) of q, k and v)
    and put back, bitwise; the contiguous cut is another layout."""
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=16)
    full = init_params(cfg)
    full["qkv_b"] = _rng(7).standard_normal(full["qkv_b"].shape).astype(
        np.float32)
    shards = [shard_params(full, n, r) for r in range(n)]
    back = full_params(shards)
    for name, v in full.items():
        assert np.array_equal(back[name].numpy(), v), name
    H, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_heads
    w = H // n
    for r in range(n):
        q, k, v = np.split(full["qkv_w"], 3, axis=-1)
        want = np.concatenate([t[..., r * w:(r + 1) * w] for t in (q, k, v)],
                              -1)
        assert np.array_equal(shards[r]["qkv_w"].numpy(), want)
        assert w % hd == 0
    contiguous = tp.Split(2).take(torch.from_numpy(full["qkv_w"]), n, 0)
    assert not torch.equal(contiguous, shards[0]["qkv_w"])
    states = {name: {"moment1": v * 0.5, "moment2": v * v,
                     "beta1_pow": np.float32(0.9),
                     "beta2_pow": np.float32(0.999)}
              for name, v in full.items()}
    st_shards = [shard_opt_states(states, full, n, r) for r in range(n)]
    st_back = full_opt_states(st_shards, shards[0])
    for name, st in states.items():
        for key, v in st.items():
            assert np.array_equal(np.asarray(st_back[name][key]),
                                  np.asarray(v)), (name, key)
    assert set(MP_SPLITS) <= set(full)


def test_sp_ranks_of_a_plain_model_are_replicas():
    """A model that does not split the sequence trains on a dp x sp mesh
    as on its dp ranks alone, bitwise: its sp ranks hold replicas and its
    gradients are not summed over sp (GPT's are: tests/
    test_torch_gpt_hybrid_sp.py)."""
    paddle.seed(11)
    init = _weights(_JTPBlock())
    x = _rng(8).standard_normal((8, 16)).astype(np.float32)
    y = _rng(8).integers(0, 4, size=(8,)).astype(np.int64)

    def fn(rank, mesh):
        m = load_named_params(_TPBlock(), init)
        step = ShardedTrainStep(m, _ce, SGD(learning_rate=0.05), mesh=mesh)
        return [float(step(x, y)) for _ in range(2)], {
            n: p.detach().clone() for n, p in m.named_parameters()}
    rep = LoopbackWorld(4).run(fn, axes={"dp": 2, "sp": 2})
    dp = LoopbackWorld(2).run(fn, axes={"dp": 2})
    for r in rep:
        assert r[0] == dp[0][0]
        for n, t in dp[0][1].items():
            assert torch.equal(r[1][n], t), n
