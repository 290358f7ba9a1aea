"""The mesh-sharded device table of the port
(paddle_tpu_torch/distributed/ps/device_table.py): the static-shape dedup,
``mesh_sharded_lookup``, ``MeshShardedEmbedding`` and
``DeviceEmbeddingTrainStep``, held to the reference on the same numpy
inputs at K = 1 (one rank) and K = 2 (``LoopbackWorld`` threads against
the reference's 2-device sub-mesh of the 8 virtual CPU devices).

Tolerances: the dedup, the tables' draws, the hot-row sketch and every
forward lookup bitwise; the lookup's gradient and 3 steps of
DeviceEmbeddingTrainStep (losses, the whole table, the dense parameters,
these relative to the largest of them) within 1e-6 relative; rows no
batch touches bitwise unchanged."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.ps import device_table as jdt
from paddle_tpu.parallel import get_mesh as jget_mesh
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import set_mesh as jset_mesh
from paddle_tpu_torch.distributed.ps import device_table as dt
from paddle_tpu_torch.models import (load_embedding_table, load_named_params,
                                     ps_tables_from_jax)
from paddle_tpu_torch.nn import Layer, Linear
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.parallel import LoopbackWorld

V, D, FIELDS = 64, 8, 3
TOL = 1e-6
STEPS = 3


@pytest.fixture
def jmesh():
    """Set the reference's mesh to the first k devices; restored after."""
    prev = jget_mesh()
    yield lambda k: jset_mesh(jmake_mesh({"dp": k},
                                         devices=jax.devices()[:k]))
    jset_mesh(prev)


def _ids(shape, seed=0, hi=V):
    return np.random.default_rng(seed).integers(0, hi, size=shape).astype(
        np.int64)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _ranks(k, fn):
    """fn(rank, mesh) on k LoopbackWorld ranks, or on one with no mesh."""
    return LoopbackWorld(k).run(fn) if k > 1 else [fn(0, None)]


def test_sort_dedup_matches_reference():
    """Distinct ids packed low in ascending order, zeros after, ``inv``
    never past the distinct count: bitwise the reference's."""
    for seed, hi in ((0, 5), (1, 1000), (2, 2)):
        flat = _ids((40,), seed, hi)
        got = [t.numpy() for t in dt._sort_dedup(torch.from_numpy(flat))]
        want = [np.asarray(t) for t in jdt._sort_dedup(
            jnp.asarray(flat.astype(np.int32)))]
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        n = len(np.unique(flat))
        assert (got[0][n:] == 0).all() and got[1].max() == n - 1
        assert np.array_equal(got[0][got[1]], flat)


def test_hot_row_sketch_matches_reference():
    ref, got = jdt.HotRowSketch(4, capacity=8), dt.HotRowSketch(4, capacity=8)
    rng = np.random.default_rng(0)
    for _ in range(5):
        ids = (rng.zipf(1.5, size=64) % 50).astype(np.int64)
        ref.update(ids)
        got.update(ids)
    got.merge(ref.top())
    ref.merge(ref.top())
    assert got.snapshot() == ref.snapshot()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [None, 3])
def test_lookup_matches_reference(jmesh, k, capacity):
    """Forward bitwise and the table's gradient within 1e-6 of the
    reference's lookup (duplicate ids summed; at K = 2 the exchange, ids
    past ``capacity`` reading zeros and passing no gradient; at K = 1 the
    plain gather, which has no capacity)."""
    jmesh(k)
    w = np.random.default_rng(1).standard_normal((V, D)).astype(np.float32)
    ids = _ids((8, FIELDS), seed=2, hi=12)
    cot = np.random.default_rng(3).standard_normal((8, FIELDS, D)).astype(
        np.float32)

    def ref_loss(w_):
        out = jdt.mesh_sharded_lookup(w_, jnp.asarray(ids), axis="dp",
                                      capacity=capacity)
        return (out * cot).sum(), out
    (_, want), want_g = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        jnp.asarray(w))

    def fn(rank, mesh):
        rows = V // k
        w_l = torch.from_numpy(w[rank * rows:(rank + 1) * rows].copy())
        w_l.requires_grad_()
        out = dt.mesh_sharded_lookup(w_l, torch.from_numpy(ids), axis="dp",
                                     capacity=capacity)
        (out * torch.from_numpy(cot)).sum().backward()
        return out.detach().numpy(), w_l.grad.numpy()
    got = _ranks(k, fn)
    for out, _ in got:
        assert np.array_equal(out, np.asarray(want))
    _close(np.concatenate([g for _, g in got]), want_g)


def test_plain_lookup_clamps_as_the_reference(jmesh):
    """At K = 1 out-of-range ids read as the reference's ``w[ids]`` does;
    at K = 2 they own no row and read zeros, as in the reference."""
    w = np.arange(V * D, dtype=np.float32).reshape(V, D)
    ids = np.array([[-1, V + 5], [3, -V - 2]])
    for k in (1, 2):
        jmesh(k)
        want = np.asarray(jax.jit(lambda w_, i: jdt.mesh_sharded_lookup(
            w_, i))(jnp.asarray(w), jnp.asarray(ids)))     # traced at k
        got = _ranks(k, lambda r, m: dt.mesh_sharded_lookup(
            torch.from_numpy(w[r * V // k:(r + 1) * V // k].copy()),
            torch.from_numpy(ids)).numpy())
        for g in got:
            assert np.array_equal(g, want), k


@pytest.mark.parametrize("k", [1, 2])
def test_embedding_layer_draw_and_padding(jmesh, k):
    """The table is padded to a multiple of K and drawn (V', E) from
    ``default_rng(seed)``: each rank's block bitwise the reference's rows;
    the forward bitwise the reference's."""
    jmesh(k)
    ref = jdt.MeshShardedEmbedding(51, D, mesh_axis="dp", seed=4)
    full = ps_tables_from_jax(ref)
    assert ref._vocab_padded == 51 + (k - 1)
    ids = _ids((4, FIELDS), seed=5, hi=51)
    want = np.asarray(ref(paddle.to_tensor(ids))._data)

    def fn(rank, mesh):
        emb = dt.MeshShardedEmbedding(51, D, mesh_axis="dp", seed=4,
                                      device="cpu")
        rows = emb.weight.shape[0]
        assert np.array_equal(emb.weight.detach().numpy(),
                              full[rank * rows:(rank + 1) * rows])
        load_embedding_table(emb, full)
        return emb(torch.from_numpy(ids)).detach().numpy()
    for got in _ranks(k, fn):
        assert np.array_equal(got, want)


class _JHead(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(FIELDS * D, 1)

    def forward(self, rows):
        return self.fc(rows.reshape((rows.shape[0], -1)))


class _Head(Layer):
    def __init__(self):
        super().__init__()
        self.fc = Linear(FIELDS * D, 1, device="cpu")

    def forward(self, rows):
        return self.fc(rows.reshape(rows.shape[0], -1))


def _batches(hi=V):
    rng = np.random.default_rng(6)
    ids = rng.integers(0, hi, size=(STEPS, 8, FIELDS)).astype(np.int64)
    y = rng.standard_normal((STEPS, 8, 1)).astype(np.float32)
    return ids, y


def _ref_steps(k, opt_name, table_opt, capacity, hi):
    model = _JHead()
    init = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    emb = jdt.MeshShardedEmbedding(V, D, mesh_axis="dp", seed=7,
                                   capacity=capacity)
    opt = (jopt.Adam(learning_rate=1e-2, parameters=model.parameters())
           if opt_name == "adam" else
           jopt.SGD(learning_rate=0.1, parameters=model.parameters()))

    def loss_fn(m, rows, y):
        return ((m(rows) - y) ** 2).mean()
    step = jdt.DeviceEmbeddingTrainStep(model, loss_fn, opt, emb,
                                        table_optimizer=table_opt,
                                        table_lr=0.1)
    ids, y = _batches(hi)
    losses = [float(step(paddle.to_tensor(ids[j]), paddle.to_tensor(y[j])))
              for j in range(STEPS)]
    params = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    return init, losses, np.asarray(step._w), params


def _port_steps(k, opt_name, table_opt, capacity, hi, init):
    ids, y = _batches(hi)

    def fn(rank, mesh):
        model = _Head()
        load_named_params(model, init)
        emb = dt.MeshShardedEmbedding(V, D, mesh_axis="dp", seed=7,
                                      capacity=capacity, device="cpu")
        opt = (Adam(learning_rate=1e-2) if opt_name == "adam"
               else SGD(learning_rate=0.1))

        def loss_fn(m, rows, y):
            return ((m(rows) - y) ** 2).mean()
        step = dt.DeviceEmbeddingTrainStep(model, loss_fn, opt, emb,
                                           table_optimizer=table_opt,
                                           table_lr=0.1, device="cpu")
        losses = [float(step(torch.from_numpy(ids[j]),
                             torch.from_numpy(y[j]))) for j in range(STEPS)]
        w = step.sync_table()
        assert w is emb.weight
        return (losses, w.detach().numpy().copy(),
                {n: p.detach().numpy() for n, p in model.named_parameters()})
    return _ranks(k, fn)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", [("adam", "adagrad", None),
                                  ("sgd", "sgd", None),
                                  ("sgd", "adagrad", 5)],
                         ids=["adam-adagrad", "sgd-sgd", "capacity5"])
def test_device_train_step_matches_reference(jmesh, k, case):
    """3 steps of a dense head over a 64 x 8 table: the losses, the whole
    table and the head within 1e-6 of the reference's step on the same
    K (the head's parameters relative to its largest: Adam's steps on a
    near-zero bias are rounding-sized against its own scale); ids only
    below 40, so the rows above stay bitwise unchanged (the update
    touches rows, it is no dense sweep); every rank reads the same loss
    and head."""
    jmesh(k)
    hi = 40
    init, want_l, want_w, want_p = _ref_steps(k, *case, hi)
    got = _port_steps(k, *case, hi, init)
    table = np.concatenate([g[1] for g in got])
    _close(got[0][0], want_l)
    _close(table, want_w)
    scale = max(float(np.abs(v).max()) for v in want_p.values())
    for n, v in want_p.items():
        assert float(np.abs(got[0][2][n] - v).max()) <= TOL * scale, n
    start = dt.init_table(V, D, 0.05, 7)
    assert np.array_equal(table[hi:], start[hi:])
    assert (table[:hi] != start[:hi]).any()
    for g in got[1:]:
        assert g[0] == got[0][0]
        assert all(np.array_equal(g[2][n], got[0][2][n]) for n in want_p)


def test_train_step_refusals():
    """A mesh without the table's axis raises, as do an unknown table
    optimizer and a model off the step's device."""
    def fn(rank, mesh):
        emb = dt.MeshShardedEmbedding(V, D, mesh_axis="mp", device="cpu",
                                      mesh=None)
        with pytest.raises(ValueError, match="lacks the table axis"):
            dt.DeviceEmbeddingTrainStep(_Head(), None, SGD(), emb,
                                        mesh=mesh, device="cpu")
        return True
    assert LoopbackWorld(2).run(fn) == [True, True]
    emb = dt.MeshShardedEmbedding(V, D, device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        dt.DeviceEmbeddingTrainStep(_Head(), None, SGD(), emb,
                                    table_optimizer="adam", device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        dt.DeviceEmbeddingTrainStep(_Head().to("meta"), None, SGD(), emb,
                                    device="cpu")


@pytest.mark.parametrize("rows, dim, block", [(1000, 65, 2), (999, 9, 64),
                                              (3001, 65, 4096), (3, 1, 2),
                                              (10, 3, 1000), (0, 65, 64)])
def test_init_table_in_blocks_is_the_reference_draw(monkeypatch, rows, dim,
                                                    block):
    """A table drawn in blocks (each on its own thread, from the seed's
    stream advanced to the block's start) is bitwise the reference's one
    stream: odd widths, blocks that end inside a row, one block, none."""
    monkeypatch.setattr(dt, "DRAW_BLOCK", block)
    r = 0.05
    want = np.random.default_rng(7).random((rows, dim), dtype=np.float32)
    want *= np.float32(2.0 * r)
    want -= np.float32(r)
    got = dt.init_table(rows, dim, r, 7)
    assert got.dtype == np.float32 and np.array_equal(got, want)
