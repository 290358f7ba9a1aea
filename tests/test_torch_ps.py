"""The parameter server's in-process tiers of the port
(paddle_tpu_torch/distributed/ps: the host tables, the communicator,
DistributedEmbedding, PSTrainStep, ShardedEmbedding) and the rank models
(paddle_tpu_torch/models/rank.py), held to the reference on the same numpy
inputs, on the CPU.

Tolerances: a host table that takes the same pushes as the reference's is
bitwise equal to it, and the bf16 rounding of the pulled rows bitwise
``ml_dtypes``'; PSTrainStep's losses and table rows after 3 steps within
1e-5 relative, unpipelined and prefetched, f32 and bf16 transfer, its
dense parameters within 1e-5 absolute and relative (Adam moves a
near-zero bias by steps of 1e-2, where 1e-5 of its own size is below the
f32 rounding of the step); the rank
models' losses over 3 steps within 1e-5 relative (Adam, dense gradients),
at one rank and at dp x mp = 4 x 2 on ``LoopbackWorld`` threads.  Widths
are 8-64 and tables of 1,000 rows, so the file runs in seconds."""
import gc
import time
import weakref

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import ps as jps
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import rank as jrank
from paddle_tpu.parallel import ShardedTrainStep as JSharded
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import set_mesh as jset_mesh
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (DeepFM, WideDeep, WideDeepHost,
                                     load_named_params)
from paddle_tpu_torch.models.convert import ps_tables_from_jax
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep

REL = 1e-5
PARAM = 1e-5     # the dense parameters after Adam steps, absolute and relative
STEPS = 3


@pytest.fixture(autouse=True)
def one_device_mesh():
    jset_mesh(jmake_mesh({"dp": 1}))
    yield


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


def _named(ref):
    return {n: np.asarray(p._data) for n, p in ref.named_parameters()}


# -- the host tables and the communicator ------------------------------------
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_host_table_bitwise_after_the_same_pushes(opt):
    """The draw, pulls and pushes with duplicate ids (summed) of both
    optimizers, and the state round trip, bitwise the reference's."""
    rng = np.random.default_rng(0)
    ref = jps.HostEmbeddingTable(100, 8, optimizer=opt, learning_rate=0.1,
                                 seed=3)
    got = ps.HostEmbeddingTable(100, 8, optimizer=opt, learning_rate=0.1,
                                seed=3)
    assert np.array_equal(got._table, ref._table)
    for _ in range(3):
        ids = rng.integers(0, 100, (6, 4))
        g = rng.standard_normal((6, 4, 8)).astype(np.float32)
        ref.push(ids, g)
        got.push(ids, g)
    ids = np.arange(100)
    assert np.array_equal(got.pull(ids), ref.pull(ids))
    t2 = ps.HostEmbeddingTable(100, 8, optimizer=opt, seed=9)
    t2.set_state_dict(ps_tables_from_jax(ref))
    assert np.array_equal(t2.pull(ids), ref.pull(ids))
    if opt == "adagrad":
        assert np.array_equal(got._g2, ref._g2)
        assert np.array_equal(t2._g2, ref._g2)
    with pytest.raises(ValueError, match="unsupported"):
        ps.HostEmbeddingTable(4, 2, optimizer="adam")


def test_hash_table_bitwise_and_dynamic_vocab():
    """Rows on first touch from their per-id seed, duplicate ids summed,
    both optimizers, and the state round trip, bitwise the reference's."""
    for opt in ("sgd", "adagrad"):
        ref = jps.HashEmbeddingTable(4, optimizer=opt, learning_rate=0.5)
        got = ps.HashEmbeddingTable(4, optimizer=opt, learning_rate=0.5)
        ids = np.array([10 ** 15, 7, 10 ** 15, -3])
        assert np.array_equal(got.pull(ids), ref.pull(ids))
        assert got.num_embeddings == 3
        g = np.arange(16, dtype=np.float32).reshape(4, 4)
        ref.push(ids, g)
        got.push(ids, g)
        assert np.array_equal(got.pull(ids), ref.pull(ids))
        t2 = ps.HashEmbeddingTable(4, optimizer=opt)
        t2.set_state_dict(ps_tables_from_jax(ref))
        assert np.array_equal(t2.pull(ids), ref.pull(ids))


def test_communicator_modes():
    """sync applies at once; async applies everything by flush; geo folds
    every k pushes: the table bitwise the reference's after each."""
    for mode in ("sync", "async", "geo"):
        tabs = [m.HostEmbeddingTable(50, 2, optimizer="sgd",
                                     learning_rate=1.0)
                for m in (jps, ps)]
        comms = [m.AsyncCommunicator(t, mode=mode, k_steps=3)
                 for m, t in zip((jps, ps), tabs)]
        for j in range(5):
            for c in comms:
                c.push(np.asarray([7, j]), np.ones((2, 2), np.float32))
            if mode == "geo" and j == 1:           # not folded yet
                assert np.array_equal(tabs[1].pull(np.asarray([7])),
                                      tabs[1]._table[[7]])
        for c in comms:
            c.flush()
        assert np.array_equal(tabs[1]._table, tabs[0]._table), mode
        for c in comms:
            c.stop()
    with pytest.raises(ValueError, match="mode"):
        ps.AsyncCommunicator(tabs[1], mode="bulk")


def test_async_worker_does_not_pin_the_table():
    """The async worker holds only weak references: a dropped
    communicator and table are collected and the thread exits."""
    t = ps.HostEmbeddingTable(50, 2, optimizer="sgd", learning_rate=1.0,
                              initializer_range=0.0)
    comm = ps.AsyncCommunicator(t, mode="async")
    comm.push(np.asarray([3]), np.ones((1, 2), np.float32))
    comm.flush()
    np.testing.assert_array_equal(t.pull(np.asarray([3]))[0], -1.0)
    thread, table_ref = comm._thread, weakref.ref(t)
    del comm, t
    deadline = time.monotonic() + 2.0
    while table_ref() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.02)
    assert table_ref() is None
    thread.join(timeout=2.0)
    assert not thread.is_alive()


def test_queued_pushes_drain_into_a_live_table():
    """Flush before drop: a communicator collected with pushes queued
    applies them where the table lives on elsewhere."""
    t = ps.HostEmbeddingTable(10, 2, optimizer="sgd", learning_rate=1.0,
                              initializer_range=0.0)
    comm = ps.AsyncCommunicator(t, mode="async")
    thread = comm._thread
    for _ in range(4):
        comm.push(np.asarray([1]), np.ones((1, 2), np.float32))
    del comm
    gc.collect()
    thread.join(timeout=2.0)
    np.testing.assert_array_equal(t.pull(np.asarray([1]))[0], -4.0)


def test_distributed_embedding_pushes_from_its_hook():
    """The eager loop: the forward pulls a leaf on the asked device, the
    backward's hook pushes its gradient rows (duplicates summed by the
    table); 3 SGD steps of a linear head, rows and losses as the
    reference's."""
    ids = np.asarray([[1, 4], [2, 1], [3, 3], [4, 2]])
    y = np.asarray([[1.0], [-1.0], [1.0], [-1.0]], np.float32)
    ref_emb = jps.DistributedEmbedding(20, 4, optimizer="sgd",
                                       learning_rate=0.5)
    emb = ps.DistributedEmbedding(20, 4, optimizer="sgd", learning_rate=0.5,
                                  device="cpu")
    w = np.random.default_rng(0).standard_normal((8, 1)).astype(np.float32)
    got, want = [], []
    for _ in range(STEPS):
        rows = ref_emb(paddle.to_tensor(ids))
        out = paddle.reshape(rows, [4, 8]) @ paddle.to_tensor(w)
        loss = ((out - paddle.to_tensor(y)) ** 2).mean()
        loss.backward()
        want.append(float(loss))
        rows = emb(torch.from_numpy(ids))
        assert rows.device.type == "cpu" and rows.requires_grad
        loss = ((rows.reshape(4, 8) @ torch.from_numpy(w)
                 - torch.from_numpy(y)) ** 2).mean()
        loss.backward()
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=REL)
    _close(emb.table._table, ref_emb.table._table)


def test_bf16_rows_bitwise_ml_dtypes():
    """The host's bf16 rounding of pulled rows is ml_dtypes' round to
    nearest even: ties, subnormals, the f32 extremes, inf and NaN."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
            -40, 38, 4096),
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 2 ** -133,
                  3.4028235e38, -3.4028235e38, 1e-45, 0.0, -0.0, np.inf,
                  -np.inf], np.float32)]).astype(np.float32)
    got = ps.bf16_rows(vals.reshape(-1, 1)).view(torch.int16).numpy()
    want = vals.reshape(-1, 1).astype(ml_dtypes.bfloat16).view(np.int16)
    assert np.array_equal(got, want)
    nan = ps.bf16_rows(np.array([[np.nan]], np.float32)).float().numpy()
    assert np.isnan(nan).all()


# -- PSTrainStep -------------------------------------------------------------
V, E, FIELDS, DD = 1000, 8, 4, 3


def _ps_data(seed=0, b=32, hi=V):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, size=(STEPS, b, FIELDS)).astype(np.int64)
    x = rng.standard_normal((STEPS, b, DD)).astype(np.float32)
    y = rng.integers(0, 2, (STEPS, b, 1)).astype(np.float32)
    return ids, x, y


def _ps_ref(transfer, piped, data):
    emb = jps.DistributedEmbedding(V, E + 1, optimizer="adagrad",
                                   learning_rate=0.05, mode="sync", seed=0)
    model = jrank.WideDeepHost(embedding_dim=E, num_fields=FIELDS,
                               dense_dim=DD, hidden=(16,))
    init = _named(model)
    opt = jopt.Adam(learning_rate=1e-2, parameters=model.parameters())

    def loss_fn(m, rows, x, y):
        return JF.binary_cross_entropy_with_logits(m(rows, x), y).mean()

    step = jps.PSTrainStep(model, loss_fn, opt, emb, transfer_dtype=transfer,
                           prefetch_depth=1 if piped else 0)
    losses = _drive(step, data, piped, paddle.to_tensor)
    return init, losses, emb.table._table.copy(), _named(model)


def _ps_port(transfer, piped, data, init, model_cls=WideDeepHost):
    emb = ps.DistributedEmbedding(V, E + 1, optimizer="adagrad",
                                  learning_rate=0.05, mode="sync", seed=0,
                                  device="cpu")
    model = model_cls(embedding_dim=E, num_fields=FIELDS, dense_dim=DD,
                      hidden=(16,), device="cpu")
    load_named_params(model, init)

    def loss_fn(m, rows, x, y):
        return F.binary_cross_entropy_with_logits(m(rows, x), y).mean()

    step = ps.PSTrainStep(model, loss_fn, Adam(learning_rate=1e-2), emb,
                          transfer_dtype=transfer,
                          prefetch_depth=1 if piped else 0, device="cpu")
    losses = _drive(step, data, piped, torch.from_numpy)
    named = {n: p.detach().numpy() for n, p in model.named_parameters()}
    return step, losses, emb.table._table, named


def _drive(step, data, piped, to):
    ids, x, y = data
    losses = []
    if piped:
        step.prefetch(ids[0])
    for n in range(STEPS):
        if piped and n + 1 < STEPS:
            step.prefetch(ids[n + 1])
        losses.append(float(step(ids[n], to(x[n]), to(y[n]))))
    step.flush()
    return losses


@pytest.mark.parametrize("transfer", ["float32", "bfloat16"])
@pytest.mark.parametrize("piped", [False, True],
                         ids=["unpipelined", "prefetched"])
def test_ps_train_step_matches_reference(transfer, piped):
    """3 steps of WideDeepHost over a 1,000 x 9 adagrad host table: the
    losses, the whole table and the dense parameters within 1e-5 relative
    of the reference's PSTrainStep; prefetched, rows pulled for step
    N + 1 reflect the pushes up to N - 1 in both."""
    data = _ps_data(seed=1, hi=50)             # duplicate ids in a batch
    init, want_l, want_t, want_p = _ps_ref(transfer, piped, data)
    _, got_l, got_t, got_p = _ps_port(transfer, piped, data, init)
    _close(got_l, want_l)
    _close(got_t, want_t)
    for n, v in want_p.items():
        np.testing.assert_allclose(got_p[n], v, rtol=PARAM, atol=PARAM)


def test_pushed_gradient_sums_duplicate_ids():
    """The pushed gradient of a unique id is the sum over its slots of
    the per-slot gradient (the gather's backward), and the push goes to
    the communicator unpipelined: held to the reference's push."""
    data = _ps_data(seed=2, b=8, hi=12)
    init = _ps_ref("float32", False, data)[0]
    pushed = []
    emb = ps.DistributedEmbedding(V, E + 1, mode="sync", device="cpu")
    model = WideDeepHost(embedding_dim=E, num_fields=FIELDS, dense_dim=DD,
                         hidden=(16,), device="cpu")
    load_named_params(model, init)

    def loss_fn(m, rows, x, y):
        return F.binary_cross_entropy_with_logits(m(rows, x), y).mean()
    step = ps.PSTrainStep(model, loss_fn, Adam(learning_rate=0.0), emb,
                          transfer_dtype="float32", device="cpu")
    emb.communicator.push = lambda i, g: pushed.append((i, g))
    ids, x, y = (d[0] for d in data)
    rows0 = torch.from_numpy(emb.table.pull(ids)).requires_grad_()
    loss = loss_fn(model, rows0, torch.from_numpy(x), torch.from_numpy(y))
    per_slot = torch.autograd.grad(loss, rows0)[0].numpy()
    step(ids, torch.from_numpy(x), torch.from_numpy(y))
    uniq, inv = np.unique(ids.reshape(-1), return_inverse=True)
    want = np.zeros((len(uniq), E + 1), np.float32)
    np.add.at(want, inv, per_slot.reshape(-1, E + 1))
    assert np.array_equal(pushed[0][0], uniq)
    np.testing.assert_allclose(pushed[0][1], want, rtol=1e-5, atol=1e-7)
    last = np.zeros_like(want)
    last[inv] = per_slot.reshape(-1, E + 1)          # duplicates not summed
    assert np.abs(last - want).max() > 1e-3


def test_unique_prep_pads_to_a_power_of_two():
    ids = np.asarray([[5, 3, 5], [900, 3, 1]])
    for n_uniq, cap in ((4, 256), (300, 512)):
        src = ids if n_uniq == 4 else np.arange(n_uniq)[::-1].reshape(3, -1)
        got = ps.PSTrainStep._unique_prep(src)
        want = jps.PSTrainStep._unique_prep(src)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert got[2].shape == (cap,)


def test_async_ps_train_step_lands_every_push():
    """mode='async': every push lands by flush, the losses fall."""
    data = _ps_data(seed=3)
    init = _ps_ref("float32", False, data)[0]
    emb = ps.DistributedEmbedding(V, E + 1, mode="async", device="cpu")
    before = emb.table._table.copy()
    model = WideDeepHost(embedding_dim=E, num_fields=FIELDS, dense_dim=DD,
                         hidden=(16,), device="cpu")
    load_named_params(model, init)

    def loss_fn(m, rows, x, y):
        return F.binary_cross_entropy_with_logits(m(rows, x), y).mean()
    step = ps.PSTrainStep(model, loss_fn, Adam(learning_rate=1e-2), emb,
                          device="cpu", prefetch_depth=0)
    ids, x, y = data
    losses = [float(step(ids[0], torch.from_numpy(x[0]),
                         torch.from_numpy(y[0]))) for _ in range(6)]
    step.flush()
    assert emb.communicator._q.unfinished_tasks == 0
    assert step.set_prefetch_depth(2) == 0 and step.prefetch_depth == 2
    assert losses[-1] < losses[0]
    touched = np.unique(ids[0])
    assert not np.allclose(emb.table._table[touched], before[touched])
    emb.communicator.stop()


# -- ShardedEmbedding and the rank models ------------------------------------
def test_sharded_embedding_lookup_and_gradient():
    """The reference's ``w[ids]``: negative ids count from the end, ids
    past the table read the last row and pass no gradient; the table is
    seed 0's uniform draw."""
    ref = jps.ShardedEmbedding(16, 4)
    got = ps.ShardedEmbedding(16, 4, device="cpu")
    assert np.array_equal(got.weight.detach().numpy(),
                          np.asarray(ref.weight._data))
    ids = np.array([[-1, 20, 3], [-30, 15, 0]])
    cot = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(
        np.float32)
    import jax
    import jax.numpy as jnp
    w = jnp.asarray(ref.weight._data)
    want_g = jax.grad(lambda w: (w[jnp.asarray(ids)] * cot).sum())(w)
    out = got(torch.from_numpy(ids))
    assert np.array_equal(out.detach().numpy(), np.asarray(w[ids]))
    (out * torch.from_numpy(cot)).sum().backward()
    assert np.array_equal(got.weight.grad.numpy(), np.asarray(want_g))


def _rank_data(seed=3, b=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, size=(b, 5)).astype(np.int64)
    dense = rng.standard_normal((b, 3)).astype(np.float32)
    y = (ids.sum(1) % 2).astype(np.float32)[:, None]
    return ids, dense, y


def _rank_ref(name, axes=None):
    """The reference's 3 Adam steps: at one rank on three batches, on
    ``axes`` on one batch three times."""
    paddle.seed(2)
    model = getattr(jrank, name)(num_features=1000, embedding_dim=8,
                                 num_fields=5, dense_dim=3, hidden=(32,))
    init = _named(model)
    opt = jopt.Adam(learning_rate=1e-2, parameters=model.parameters())

    def loss_fn(m, ids, dense, y):
        return JF.binary_cross_entropy_with_logits(m(ids, dense), y)
    if axes is None:
        step = JTrainStep(model, loss_fn, opt)
    else:
        mesh = jset_mesh(jmake_mesh(axes))
        step = JSharded(model, loss_fn, opt, mesh=mesh)
    losses = [float(step(*(paddle.to_tensor(a) for a in _rank_data(
        3 + k * (axes is None))))) for k in range(STEPS)]
    return init, losses, _named(model)


def _rank_loss(m, ids, dense, y):
    return F.binary_cross_entropy_with_logits(m(ids, dense), y)


@pytest.mark.parametrize("name", ["WideDeep", "DeepFM"])
def test_rank_models_train_as_the_reference(name):
    """3 Adam steps under TrainStep on three batches: the losses and every
    parameter (both tables whole: the gradient is dense) within 1e-5
    relative; a row touched only by the first batch still moves at the
    later steps (its moments carry on), where a lazy update would freeze
    it."""
    init, want_l, want_p = _rank_ref(name)
    cls = {"WideDeep": WideDeep, "DeepFM": DeepFM}[name]
    model = cls(num_features=1000, embedding_dim=8, num_fields=5,
                dense_dim=3, hidden=(32,), device="cpu")
    load_named_params(model, init)
    step = TrainStep(model, _rank_loss, Adam(learning_rate=1e-2))
    batches = [[torch.from_numpy(a) for a in _rank_data(3 + k)]
               for k in range(STEPS)]
    table = dict(model.named_parameters())["embedding.weight"]
    losses = [float(step(*batches[0]))]
    after_one = table.detach().clone()
    losses += [float(step(*b)) for b in batches[1:]]
    _close(losses, want_l)
    for n, v in want_p.items():
        _close(dict(model.named_parameters())[n].detach().numpy(), v)
    first = np.setdiff1d(batches[0][0].numpy(), np.concatenate(
        [b[0].numpy().ravel() for b in batches[1:]]))
    assert first.size > 0
    assert (table.detach()[first] != after_one[first]).all(dim=1).all()


@pytest.mark.parametrize("name", ["WideDeep", "DeepFM"])
def test_rank_models_train_on_dp4_mp2(name):
    """ShardedTrainStep on {"dp": 4, "mp": 2} (the reference's
    test_rank_models_train): each mp rank holds 500 rows of each table,
    the lookup the masked gather summed over mp; 3 steps' losses and the
    gathered parameters within 1e-5 of the reference's sharded step, the
    replicas bitwise equal."""
    axes = {"dp": 4, "mp": 2}
    init, want_l, want_p = _rank_ref(name, axes)
    cls = {"WideDeep": WideDeep, "DeepFM": DeepFM}[name]
    data = [torch.from_numpy(a) for a in _rank_data()]

    def fn(rank, mesh):
        model = cls(num_features=1000, embedding_dim=8, num_fields=5,
                    dense_dim=3, hidden=(32,), device="cpu")
        assert model.embedding.weight.shape == (500, 8)
        load_named_params(model, init)
        step = ShardedTrainStep(model, _rank_loss, Adam(learning_rate=1e-2),
                                mesh=mesh)
        losses = [float(step(*data)) for _ in range(STEPS)]
        return losses, {k: v.numpy() for k, v in step.gather_params().items()}
    got = LoopbackWorld(8).run(fn, axes=axes)
    _close(got[0][0], want_l)
    for n, v in want_p.items():
        _close(got[0][1][n], v)
    for r in got[1:]:
        assert r[0] == got[0][0]
        assert all(np.array_equal(r[1][n], got[0][1][n]) for n in want_p)


def test_sharded_embedding_over_dp_is_a_replica():
    """Over an axis other than mp the port keeps the whole table on every
    rank (a replica whose gradient the data-parallel step averages): on
    {"dp": 2} its rows and one SGD step are one rank's on the global
    batch."""
    from paddle_tpu_torch.optimizer import SGD
    ids = np.random.default_rng(0).integers(0, 16, (4, 3))

    def loss(m, i):
        return (m(i) ** 2).mean()

    def fn(rank, mesh):
        e = ps.ShardedEmbedding(16, 4, mesh_axis="dp", device="cpu")
        assert e.weight.shape == (16, 4)
        ShardedTrainStep(e, loss, SGD(learning_rate=0.5),
                         mesh=mesh)(torch.from_numpy(ids))
        return e.weight.detach().numpy()
    got = LoopbackWorld(2).run(fn)
    one = ps.ShardedEmbedding(16, 4, mesh_axis="dp", device="cpu")
    TrainStep(one, loss, SGD(learning_rate=0.5))(torch.from_numpy(ids))
    for g in got:
        np.testing.assert_allclose(g, one.weight.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
