"""The port's LocalSGDTrainStep and DGCTrainStep (paddle_tpu_torch/parallel/
dp_meta.py), held to the reference's (paddle_tpu/parallel/dp_meta.py) on
2- and 4-device sub-meshes of the 8 virtual CPU devices, from the same
weights (``load_named_params``), as ``LoopbackWorld`` ranks.

Tolerances: 2e-6 against the reference and against one-rank steps on
the global batch (f32 sums in another order; the model is a tanh MLP, so
nothing rounds near a kink), replicas that must agree bitwise; DGC's
exchanged index sets exact (ties taken lower index first, as
``lax.top_k``).  Under these shard_map-style steps every batch norm uses
its rank's own slice of the batch."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_named_buffers, load_named_params
from paddle_tpu_torch.nn import BatchNorm1D, Linear, SyncBatchNorm
from paddle_tpu_torch.optimizer import SGD, Momentum
from paddle_tpu_torch.parallel import (DGCTrainStep, LocalSGDTrainStep,
                                       LoopbackWorld, Mesh)

TOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The simulated ranks share the process: one intra-op thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = (x @ np.arange(1, 9, dtype=np.float32).reshape(8, 1)
         / 8).astype(np.float32)
    return x, y


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _reference(bn=False, seed=0):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    paddle.seed(seed)
    layers = [jnn.Linear(8, 16)] + ([jnn.BatchNorm1D(16)] if bn else []) + [
        jnn.Tanh(), jnn.Linear(16, 1)]
    m = jnn.Sequential(*layers)
    return (m, {n: np.asarray(p._data) for n, p in m.named_parameters()},
            {n: np.asarray(b._data) for n, b in m.named_buffers()})


def _port(weights, buffers=None, bn=False, sync=False):
    norm = SyncBatchNorm if sync else BatchNorm1D
    layers = [Linear(8, 16, device="cpu")] + (
        [norm(16, device="cpu")] if bn else []) + [
        torch.nn.Tanh(), Linear(16, 1, device="cpu")]
    m = load_named_params(torch.nn.Sequential(*layers), weights)
    return load_named_buffers(m, buffers) if buffers else m


def _jax_mesh(n):
    import jax
    from paddle_tpu.parallel import make_mesh
    return make_mesh({"dp": n}, devices=jax.devices()[:n])


def _jnp(t):
    return {n: np.asarray(a) for n, a in t.items()}


# ---------------------------------------------------------------------------
# LocalSGD
# ---------------------------------------------------------------------------

LOCAL = dict(k_steps=2, begin_step=3)


def _jax_localsgd(n, steps, bn=False, **kw):
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel.dp_meta import LocalSGDTrainStep as J
    m, _, _ = _reference(bn)
    s = J(m, _mse, jopt.SGD(learning_rate=0.1), mesh=_jax_mesh(n), **kw)
    x, y = _data()
    out = []
    for _ in range(steps):
        loss = float(s(paddle.to_tensor(x), paddle.to_tensor(y)))
        out.append((loss, _jnp(s.replica_params()), s.k_steps,
                    _jnp(s._stacked[2])))
    s.sync_params()
    return out, {n: np.asarray(p._data) for n, p in m.named_parameters()}


def _port_localsgd(n, steps, bn=False, **kw):
    _, w, b = _reference(bn)
    x, y = _data()

    def fn(rank, mesh):
        m = _port(w, b, bn)
        s = LocalSGDTrainStep(m, _mse, SGD(learning_rate=0.1), **kw)
        out = []
        for _ in range(steps):
            loss = float(s(x, y))
            out.append((loss, {k: v.numpy() for k, v in
                               s.replica_params().items()}, s.k_steps,
                        {k: v.numpy().copy() for k, v in m.named_buffers()}))
        s.sync_params()
        return out, {k: p.detach().numpy() for k, p in m.named_parameters()}
    return LoopbackWorld(n).run(fn)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("adaptive", [False, True])
def test_localsgd_matches_reference(n, adaptive):
    """Warm-up (synchronous dp before begin_step), local steps, averaging
    every k: each step's loss, every rank's replica and k (adaptive
    re-derives it from the loss ratio) as the reference's; replicas differ
    between syncs and are bitwise equal after one; sync_params writes the
    mean back on every rank."""
    kw = dict(LOCAL, adaptive=adaptive)
    want, want_final = _jax_localsgd(n, 6, **kw)
    ranks = _port_localsgd(n, 6, **kw)
    for i, (loss, reps, k, _) in enumerate(want):
        for r, (got, _) in enumerate(ranks):
            g_loss, g_reps, g_k, _ = got[i]
            np.testing.assert_allclose(g_loss, loss, rtol=TOL, atol=TOL)
            assert g_k == k
            for name, stacked in reps.items():
                np.testing.assert_allclose(g_reps[name], stacked, rtol=TOL,
                                           atol=TOL, err_msg=name)
    for i in range(6):
        rep, ref = ranks[0][0][i][1]["0.weight"], want[i][1]["0.weight"]
        same = all(np.array_equal(rep[0], rep[j]) for j in range(n))
        assert same == all(np.array_equal(ref[0], ref[j]) for j in range(n))
        if not adaptive:        # warm-up through step 1, then every k = 2
            assert same == (i in (0, 1, 3, 5)), i
    for r in range(n):
        for name, v in want_final.items():
            np.testing.assert_allclose(ranks[r][1][name], v, rtol=TOL,
                                       atol=TOL)
            assert np.array_equal(ranks[r][1][name], ranks[0][1][name])


def test_localsgd_keeps_each_ranks_batch_statistics():
    """A batch norm under LocalSGD normalises by the rank's slice: the
    running statistics differ by rank between syncs, each the
    reference's replica's, and are averaged at a sync."""
    want, _ = _jax_localsgd(2, 4, bn=True, k_steps=3, begin_step=1)
    ranks = _port_localsgd(2, 4, bn=True, k_steps=3, begin_step=1)
    for i in range(4):
        stacked = want[i][3]
        for r in range(2):
            for name, v in ranks[r][0][i][3].items():
                np.testing.assert_allclose(v, stacked[name][r], rtol=TOL,
                                           atol=TOL, err_msg=name)
        m0 = ranks[0][0][i][3]["1._mean"]
        assert np.array_equal(m0, ranks[1][0][i][3]["1._mean"]) == (i == 2)


# ---------------------------------------------------------------------------
# DGC
# ---------------------------------------------------------------------------

def _jax_dgc(n, steps, **kw):
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel.dp_meta import DGCTrainStep as J
    m, _, _ = _reference()
    s = J(m, _mse, jopt.SGD(learning_rate=0.1), mesh=_jax_mesh(n), **kw)
    x, y = _data(seed=4)
    losses = [float(s(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(steps)]
    return losses, {n: np.asarray(p._data) for n, p in m.named_parameters()
                    }, set(s._fns), [_jnp(t) for t in s._uv]


def _port_dgc(n, steps, bn=False, sync=False, **kw):
    _, w, b = _reference(bn)
    x, y = _data(seed=4)

    def fn(rank, mesh):
        m = _port(w, b, bn, sync)
        s = DGCTrainStep(m, _mse, SGD(learning_rate=0.1), **kw)
        losses = [float(s(x, y)) for _ in range(steps)]
        return (losses, {k: p.detach().numpy() for k, p in
                         m.named_parameters()}, s.stages_seen,
                [{k: t.numpy() for k, t in d.items()} for d in s._uv],
                {k: v.numpy() for k, v in m.named_buffers()})
    return LoopbackWorld(n).run(fn)


def test_dgc_dense_rampup_is_momentum_sgd_on_the_global_batch():
    """Before rampup_begin_step the exchange is dense: two steps equal
    TrainStep with Momentum(0.1, 0.9) on the global batch, and the
    reference's DGC."""
    kw = dict(momentum=0.9, sparsity=[0.9], rampup_begin_step=100)
    want_l, want_p, _, _ = _jax_dgc(2, 2, **kw)
    got = _port_dgc(2, 2, **kw)
    _, w, _ = _reference()
    m = _port(w)
    x, y = _data(seed=4)
    s = TrainStep(m, _mse, Momentum(learning_rate=0.1, momentum=0.9))
    plain = [float(s(x, y)) for _ in range(2)]
    for losses, params, stages, _, _ in got:
        assert stages == {0.0}
        np.testing.assert_allclose(losses, want_l, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(losses, plain, rtol=TOL, atol=TOL)
        for k, p in m.named_parameters():
            np.testing.assert_allclose(params[k], p.detach().numpy(),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(params[k], want_p[k], rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_dgc_sparse_steps_match_reference(n):
    """A dense step, then sparsity 0.5 for two calls and 0.75 after: the
    losses, parameters, every rank's u and v and the stages run as the
    reference's; the replicas bitwise equal."""
    kw = dict(momentum=0.9, sparsity=[0.5, 0.75], rampup_begin_step=1,
              rampup_step=2)
    want_l, want_p, want_stages, want_uv = _jax_dgc(n, 6, **kw)
    got = _port_dgc(n, 6, **kw)
    for r, (losses, params, stages, uv, _) in enumerate(got):
        assert stages == want_stages == {0.0, 0.5, 0.75}
        np.testing.assert_allclose(losses, want_l, rtol=TOL, atol=TOL)
        for k in params:
            np.testing.assert_array_equal(params[k], got[0][1][k])
            np.testing.assert_allclose(params[k], want_p[k], rtol=TOL,
                                       atol=TOL)
        for mine, ref in zip(uv, want_uv):
            for k in mine:
                np.testing.assert_allclose(mine[k], ref[k][r], rtol=TOL,
                                           atol=TOL, err_msg=k)
                np.testing.assert_array_equal(mine[k] == 0, ref[k][r] == 0)


def test_dgc_ties_select_the_lower_index_and_reconstruct():
    """|v| with ties: each rank's exchanged set is lax.top_k's (the lower
    index first), the dense result is the scatter of both ranks' (values,
    indices) divided by dp, and the exchanged u and v entries are 0."""
    import jax
    import jax.numpy as jnp
    g = np.array([[3.0, -3.0, 1.0, 3.0, -1.0, 2.0, -2.0, 3.0],
                  [1.0, 1.0, -1.0, 1.0, 2.0, -2.0, 2.0, 0.5]], np.float32)
    k = DGCTrainStep.top_k(8, 0.5)

    def fn(rank, mesh):
        s = DGCTrainStep(Linear(2, 2, device="cpu"), _mse, SGD(),
                         momentum=0.9)
        zeros = torch.zeros(8)
        return [t.numpy() for t in s._compress(torch.from_numpy(g[rank]),
                                               zeros, zeros.clone(), 0.5)]
    got = LoopbackWorld(2).run(fn)
    dense = np.zeros(8, np.float32)
    for r in range(2):
        idx = np.sort(np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(g[r])),
                                               k)[1]))
        _, u, v = got[r]
        assert sorted(np.flatnonzero(v == 0)) == list(idx)
        assert sorted(np.flatnonzero(u == 0)) == list(idx)
        np.add.at(dense, idx, g[r][idx])
    for r in range(2):
        np.testing.assert_array_equal(got[r][0], dense / 2)
    assert list(np.sort(np.asarray(jax.lax.top_k(
        jnp.abs(jnp.asarray(g[0])), k)[1]))) == [0, 1, 3, 7]


def test_shard_map_style_steps_keep_local_batch_statistics():
    """DGC with a SyncBatchNorm: each rank's running statistics are those
    of its own slice (SyncBatchNorm syncs nothing here), so the ranks'
    differ; both are what a batch norm takes from that slice alone."""
    got = _port_dgc(2, 1, bn=True, sync=True, sparsity=[0.5])
    _, w, b = _reference(True)
    x, _ = _data(seed=4)
    for r in range(2):
        m = _port(w, b, bn=True)
        with torch.no_grad():
            m(torch.from_numpy(x[r * 8:(r + 1) * 8]))
        for k, v in m.named_buffers():
            np.testing.assert_allclose(got[r][4][k], v.numpy(), rtol=1e-6,
                                       atol=1e-7)
    assert not np.array_equal(got[0][4]["1._mean"], got[1][4]["1._mean"])


def test_pure_data_parallel_steps_refuse_other_axes():
    _, w, _ = _reference()

    def fn(rank, mesh):
        hybrid = Mesh({"dp": 1, "sharding": 2}, mesh.group)
        for cls in (LocalSGDTrainStep, DGCTrainStep):
            with pytest.raises(ValueError, match="pure data-parallel"):
                cls(_port(w), _mse, SGD(), mesh=hybrid)
        return True
    assert LoopbackWorld(2).run(fn) == [True, True]
