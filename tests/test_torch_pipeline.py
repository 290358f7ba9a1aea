"""The pipeline's two schedules (paddle_tpu_torch/parallel/pipeline.py)
held to the reference's ``make_pipeline_train_1f1b`` and
``pipeline_forward`` on its toy stage (``tests/test_pipeline_1f1b.py``: a
tanh MLP, L = 8 layers of width D = 16, a linear head and a squared-error
loss).

The reference runs on its 8-device CPU mesh at ``{"pp": 4, "dp": 2}``
(once per module, four programs); the port's ranks are ``LoopbackWorld``
threads on the same mesh, each holding its stage's two layers and its
data rank's half of the batch.  f32, 1e-5 on the loss and on every
gradient (stacked, head, the input's).  Under F-then-B the port's
per-rank loss is its half's: the mean over the data ranks of the losses
and gradients is the reference's (what ``ShardedTrainStep`` takes)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import set_mesh as jset_mesh
from paddle_tpu.parallel.pipeline import _b_sched as j_b_sched
from paddle_tpu.parallel.pipeline import _f_sched as j_f_sched
from paddle_tpu.parallel.pipeline import \
    make_pipeline_train_1f1b as jmake_1f1b
from paddle_tpu.parallel.pipeline import pipeline_forward as jpipeline
from paddle_tpu_torch.parallel import (LoopbackWorld, make_pipeline_train_1f1b,
                                       pipeline_forward)
from paddle_tpu_torch.parallel import pipeline

TOL = 1e-5
L, D, B = 8, 16, 16
AXES = {"pp": 4, "dp": 2}


def _j_stage(local_params, x):
    w, b = local_params

    def layer(h, wb):
        return jnp.tanh(h @ wb[0] + wb[1]), None
    return jax.lax.scan(layer, x, (w, b))[0]


def _j_head(head_params, y, labels):
    return ((y @ head_params["w"] - labels) ** 2).mean()


def _stage(local_params, x):
    w, b = local_params
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i] + b[i])
    return x


def _head(head_params, y, labels):
    return ((y @ head_params["w"] - labels) ** 2).mean()


def _arrays():
    """The reference test's parameters and a batch of B rows."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((L, D, D)).astype(np.float32) * 0.2
    b = np.zeros((L, D), np.float32)
    wo = rng.standard_normal((D, 4)).astype(np.float32) * 0.2
    data = np.random.default_rng(1)
    x = data.standard_normal((B, D)).astype(np.float32)
    lab = data.standard_normal((B, 4)).astype(np.float32)
    return w, b, wo, x, lab


def _jax_grads(f, w, b, wo, x):
    loss, g = jax.value_and_grad(f, argnums=(0, 1, 2))(
        (jnp.asarray(w), jnp.asarray(b)), {"w": jnp.asarray(wo)},
        jnp.asarray(x))
    (gw, gb), gh, gx = g
    return [float(loss)] + [np.asarray(a) for a in (gw, gb, gh["w"], gx)]


@pytest.fixture(scope="module")
def reference():
    """{M: (loss, dw, db, dwo, dx)} of the reference's 1F1B at M = 4 and 8
    and of ``pipeline_forward`` + head at M = 4 ("fthenb"), all on
    ``AXES``; its dense fallback on {"dp": 2} ("dense")."""
    w, b, wo, x, lab = _arrays()
    labels = jnp.asarray(lab)
    out = {}
    mesh = jset_mesh(jmake_mesh(AXES, devices=jax.devices()[:8]))
    for m in (4, 8):
        fn = jmake_1f1b(_j_stage, _j_head, m, mesh=mesh)
        out[m] = _jax_grads(lambda s, h, xx: fn(s, h, xx, labels),
                            w, b, wo, x)
    out["fthenb"] = _jax_grads(
        lambda s, h, xx: _j_head(h, jpipeline(_j_stage, s, xx, 4, mesh=mesh),
                                 labels), w, b, wo, x)
    dmesh = jset_mesh(jmake_mesh({"dp": 2}, devices=jax.devices()[:2]))
    fn = jmake_1f1b(_j_stage, _j_head, 4, mesh=dmesh)
    out["dense"] = _jax_grads(lambda s, h, xx: fn(s, h, xx, labels),
                              w, b, wo, x)
    return out


def _port(axes, mode, m, **kw):
    """Each rank's (loss, dw of its stage, db, dwo, dx of its rows, the
    peak of its live microbatch graphs) under schedule ``mode``."""
    w, b, wo, x, lab = _arrays()
    n_pp, n_dp = axes.get("pp", 1), axes.get("dp", 1)

    def fn(rank, mesh):
        s, d = mesh.axis_index("pp"), mesh.axis_index("dp")
        n, rows = L // n_pp, B // n_dp
        leaves = [torch.tensor(a).requires_grad_() for a in (
            w[s * n:(s + 1) * n], b[s * n:(s + 1) * n], wo,
            x[d * rows:(d + 1) * rows])]
        wl, bl, wol, xl = leaves
        ll = torch.tensor(lab[d * rows:(d + 1) * rows])
        pipeline.reset_live_graphs()
        if mode == 1:
            loss = make_pipeline_train_1f1b(_stage, _head, m, mesh=mesh,
                                            **kw)((wl, bl), {"w": wol}, xl,
                                                  ll)
        else:
            loss = _head({"w": wol}, pipeline_forward(
                _stage, (wl, bl), xl, m, mesh=mesh), ll)
        loss.backward()
        return ([float(loss.detach())] + [t.grad.numpy() for t in leaves]
                + [pipeline.peak_live_graphs(), pipeline.live_graphs()])
    return LoopbackWorld(n_pp * n_dp).run(fn, axes=axes)


def _check(got, want, axes, mean_over_dp):
    """The ranks' readings against the reference's global ones: each
    stage's slice of dw / db, dwo, each data rank's rows of dx; with
    ``mean_over_dp`` the ranks' losses and parameter gradients are first
    averaged over the data ranks (and dx divided by their number)."""
    n_pp, n_dp = axes.get("pp", 1), axes.get("dp", 1)
    n, rows = L // n_pp, B // n_dp
    for r, g in enumerate(got):
        s, d = divmod(r, n_dp)
        group = got[s * n_dp:(s + 1) * n_dp]
        avg = (lambda i: np.mean([q[i] for q in group], 0)) \
            if mean_over_dp else (lambda i: g[i])
        scale = n_dp if mean_over_dp else 1
        np.testing.assert_allclose(avg(0), want[0], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(avg(1), want[1][s * n:(s + 1) * n],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(avg(2), want[2][s * n:(s + 1) * n],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(avg(3), want[3], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g[4] / scale,
                                   want[4][d * rows:(d + 1) * rows],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m", [4, 8])
def test_1f1b_matches_reference(reference, m):
    """1F1B at pp = 4 x dp = 2: the loss (the data ranks' mean), the
    stage's, the head's and the input's gradients as the reference's;
    every rank the same loss and head gradient; at most P - s live
    microbatch graphs on stage s, none left."""
    got = _port(AXES, 1, m)
    _check(got, reference[m], AXES, mean_over_dp=False)
    assert all(g[0] == got[0][0] for g in got)
    assert all(np.array_equal(g[3], got[0][3]) for g in got)
    for r, g in enumerate(got):
        stage = r // AXES["dp"]
        assert g[5] == AXES["pp"] - stage <= AXES["pp"]
        assert g[6] == 0


def test_fthenb_matches_reference(reference):
    """pipeline_forward + the head under autograd at pp = 4 x dp = 2 as
    the reference's under jax.grad; every stage holds all M graphs."""
    got = _port(AXES, 0, 4)
    _check(got, reference["fthenb"], AXES, mean_over_dp=True)
    assert [g[5] for g in got] == [4] * 8
    assert all(g[6] == 0 for g in got)


def test_schedules_agree():
    """F-then-B and 1F1B on the port: the same loss and gradients (1e-5)
    at pp = 4, M = 8, one data rank."""
    axes = {"pp": 4, "dp": 1}
    f0, f1 = _port(axes, 0, 8), _port(axes, 1, 8)
    for a, b in zip(f0, f1):
        for x, y in zip(a[:5], b[:5]):
            np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL)
    assert [g[5] for g in f0] == [8] * 4 and [g[5] for g in f1] == [4, 3,
                                                                    2, 1]


def test_dense_fallback(reference):
    """No pp axis: the dense composition with the reference's
    normalisations on {"dp": 2} (the loss and gradients its global ones),
    and at one rank the stage and head under autograd."""
    got = _port({"dp": 2}, 1, 4)
    _check(got, reference["dense"], {"dp": 2}, mean_over_dp=False)
    one = _port({"dp": 1}, 1, 4)[0]
    w, b, wo, x, lab = _arrays()
    ts = [torch.tensor(a).requires_grad_() for a in (w, b, wo, x)]
    want = _head({"w": ts[2]}, _stage(ts[:2], ts[3]), torch.tensor(lab))
    want.backward()
    np.testing.assert_allclose(one[0], float(want), rtol=TOL, atol=TOL)
    for g, t in zip(one[1:5], ts):
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=TOL, atol=TOL)
    assert one[5] == 0


@pytest.mark.parametrize("n_stages,m", [(2, 4), (4, 8), (4, 3), (8, 8)])
def test_timetable_is_a_valid_1f1b(n_stages, m):
    """The reference's timetable, tick by tick, and its checks
    (``test_pipeline_1f1b.py``): every F(m) and B(m) once per stage, F
    before B, one op a tick, at most P live, the backward chaining one
    tick a stage."""
    ticks = 2 * (m + n_stages - 1)
    f_time, b_time = {}, {}
    for s in range(n_stages):
        live = peak = 0
        for t in range(ticks):
            mf, okf = pipeline._f_sched(s, t, n_stages, m)
            mb, okb = pipeline._b_sched(s, t, n_stages, m)
            jf = j_f_sched(jnp.int32(s), jnp.int32(t), n_stages, m)
            jb = j_b_sched(jnp.int32(s), jnp.int32(t), n_stages, m)
            assert okf == bool(jf[1]) and okb == bool(jb[1]), (s, t)
            assert not (okf and okb), (s, t)
            if okf:
                assert mf == int(jf[0])
                f_time[(s, mf)] = t
                live += 1
            if okb:
                assert mb == int(jb[0])
                b_time[(s, mb)] = t
                live -= 1
            peak = max(peak, live)
        assert peak <= n_stages
    for s in range(n_stages):
        for mi in range(m):
            assert b_time[(s, mi)] > f_time[(s, mi)]
            if s > 0:
                assert f_time[(s, mi)] >= f_time[(s - 1, mi)] + 1
                assert b_time[(s - 1, mi)] == b_time[(s, mi)] + 1


def test_value_errors():
    """A batch that does not divide into M microbatches raises in both
    schedules, as the reference's; unconditional=False with a seq_axis
    on a mesh with sp > 1 raises (the reference's cond scheduler), and
    unconditional=True runs as None does."""
    def fn(rank, mesh):
        x = torch.ones(6, D)
        w = (torch.zeros(4, D, D), torch.zeros(4, D))
        with pytest.raises(ValueError, match="not divisible by 4"):
            pipeline_forward(_stage, w, x, 4, mesh=mesh)
        with pytest.raises(ValueError, match="not divisible by 4"):
            make_pipeline_train_1f1b(_stage, _head, 4, mesh=mesh)(
                w, {"w": torch.zeros(D, 4)}, x, torch.zeros(6, 4))
        with pytest.raises(ValueError, match="branch-free"):
            make_pipeline_train_1f1b(_stage, _head, 2, mesh=mesh,
                                     seq_axis="sp", unconditional=False)
        return True
    assert LoopbackWorld(4).run(fn, axes={"pp": 2, "sp": 2}) == [True] * 4
    a = _port({"pp": 2, "dp": 1}, 1, 4, unconditional=True)
    b = _port({"pp": 2, "dp": 1}, 1, 4)
    for x, y in zip(a, b):
        assert x[0] == y[0] and all(np.array_equal(p, q)
                                    for p, q in zip(x[1:5], y[1:5]))
