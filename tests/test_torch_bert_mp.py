"""BERT's tensor-parallel path (paddle_tpu_torch/models/bert.py at mp > 1)
under the port's ShardedTrainStep, held to the reference's sharded step
on dp x mp = 2 x 2 of the 8 virtual CPU devices.

``bert_tiny`` (V = 256, H = 64, 2 layers, 4 heads of 16: the dense
attention path in both packages), S = 32, B = 4, padded (a (B, S)
attention mask), 4-6 MLM labels a row and -100 elsewhere.  The port's
ranks are ``LoopbackWorld`` threads, each building its Bert under the
mesh (holding its shards, ``qkv`` head-aligned) and taking the
reference's weights through ``load_jax_params``.  f32: the gathered MLM
logits 1e-5 of one rank's, the loss 1e-5 of the reference's; 3 Adam
steps at mp = 2 and at dp x mp = 2 x 2: losses 1e-5 relative, the
gathered parameters 1e-5 relative to the largest of them.  At dp > 1
each data rank's half of the batch holds as many MLM labels as the
other's: a loss divided by a data-dependent count is, in the port, the
mean of the ranks' losses (``tests/test_torch_sharded_step.py``
``test_masked_lm_loss_is_the_mean_of_the_ranks_losses`` shows the gap).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel import ShardedTrainStep as JStep
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
from paddle_tpu_torch.models import (BERT_MP_SPLITS, Bert, bert_pretrain_loss,
                                     bert_tiny, full_params, shard_params)
from paddle_tpu_torch.models.bert import _PARAM_ORDER
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import LoopbackWorld, ShardedTrainStep, tp

TOL = 1e-5
STEPS = 3
B, S = 4, 32
CFG = dict(max_seq_len=S, remat=False)
MESHES = {"mp2": {"mp": 2}, "dp2_mp2": {"dp": 2, "mp": 2}}


@pytest.fixture(autouse=True)
def _reference_env():
    prev = get_mesh()
    yield
    set_mesh(prev)


def _batch():
    """(ids, mlm labels, nsp labels, attention mask): each half of the
    batch holds 10 MLM labels."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (B, S)).astype(np.int64)
    lens = np.array([S, S // 2 + 3, S - 5, S // 2])
    amask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int64)
    mlm = np.full((B, S), -100, np.int64)
    for b, picks in enumerate(([1, 5, 9, 30], [0, 2, 3, 4, 17, 18],
                               [7, 8, 20, 21, 26], [0, 3, 6, 9, 12])):
        mlm[b, picks] = ids[b, picks]
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, mlm, nsp, amask


def _loss(m, ids, mlm, nsp, amask):
    return bert_pretrain_loss(m, ids, mlm, nsp, attention_mask=amask)


def _jloss(m, ids, mlm, nsp, amask):
    return jbert.bert_pretrain_loss(m, ids, mlm, nsp, attention_mask=amask)


def _reference(axes):
    """The reference's initial weights and 3 Adam steps on ``axes``:
    losses (the first the loss before training), final parameters."""
    model = jbert.Bert(jbert.bert_tiny(**CFG))
    init = {n: np.array(model._parameters[n]._data) for n in _PARAM_ORDER}
    batch = [paddle.to_tensor(a) for a in _batch()]
    n = int(np.prod(list(axes.values())))
    mesh = set_mesh(make_mesh(axes, devices=jax.devices()[:n]))
    step = JStep(model, _jloss, jopt.Adam(learning_rate=1e-3,
                                          parameters=model.parameters()),
                 mesh=mesh)
    losses = [float(step(*batch)) for _ in range(STEPS)]
    final = {n: np.array(model._parameters[n]._data) for n in _PARAM_ORDER}
    return init, losses, final


@pytest.fixture(scope="module")
def reference():
    """One reference run, on dp x mp = 2 x 2: its sharded step's loss is
    the global batch's, which the port gives at mp = 2 (one data rank)
    and, the halves holding equal label counts, at dp x mp = 2 x 2."""
    return _reference(MESHES["dp2_mp2"])


def _serve(init, fault=False):
    batch = [torch.from_numpy(a) for a in _batch()]

    def fn(rank, mesh):
        model = Bert(bert_tiny(**CFG), device="cpu")
        model.load_jax_params(init)
        assert tuple(model.qkv_w.shape) == (2, 64, 96)
        if fault:                  # the reference's contiguous qkv cut
            with torch.no_grad():
                for name in ("qkv_w", "qkv_b"):
                    p = getattr(model, name)
                    split, n, idx = p.mp_split
                    p.copy_(tp.Split(split.dim).take(
                        torch.tensor(init[name]), n, idx))
        with torch.inference_mode():
            mlm, _ = model(batch[0], attention_mask=batch[3])
            return mlm.numpy(), float(_loss(model, *batch))
    return LoopbackWorld(2).run(fn, axes={"mp": 2})


def test_serving_at_mp2(reference):
    """The gathered (B, S, V) MLM logits on a padded batch at mp = 2 as
    the port's one-rank logits (``tests/test_torch_bert.py`` holds those
    to the reference), the loss as the reference's before training; the
    reference's contiguous qkv cut (rank 0 all of q and half of k) is far
    off."""
    init, (loss0, *_) = reference[:2]
    batch = [torch.from_numpy(a) for a in _batch()]
    one = Bert(bert_tiny(**CFG), device="cpu").load_jax_params(init)
    with torch.inference_mode():
        logits = one(batch[0], attention_mask=batch[3])[0].numpy()
    for lg, loss in _serve(init):
        np.testing.assert_allclose(lg, logits, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(loss, loss0, rtol=TOL)
    bad = _serve(init, fault=True)[0][0]
    assert np.abs(bad - logits).max() > 1e2 * TOL


def _train(axes, init, remat=False, steps=STEPS):
    n = int(np.prod(list(axes.values())))
    batch = [torch.from_numpy(a) for a in _batch()]

    def fn(rank, mesh):
        model = Bert(bert_tiny(**dict(CFG, remat=remat)), device="cpu")
        model.load_jax_params(init)
        step = ShardedTrainStep(model, _loss, Adam(learning_rate=1e-3),
                                mesh=mesh)
        losses = [float(step(*batch)) for _ in range(steps)]
        return losses, {k: v.numpy() for k, v in
                        step.gather_params().items()}
    return LoopbackWorld(n).run(fn, axes=axes)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_matches_reference(reference, mesh):
    """3 Adam steps at mp = 2, alone and with dp = 2: the losses and the
    gathered parameters as the reference's sharded step; every rank reads
    the same losses and parameters."""
    init, want_l, want_p = reference
    got = _train(MESHES[mesh], init)
    np.testing.assert_allclose(got[0][0], want_l, rtol=TOL)
    scale = max(float(np.abs(v).max()) for v in want_p.values())
    for n, v in want_p.items():
        assert float(np.abs(got[0][1][n] - v).max()) <= TOL * scale, n
    for r in got[1:]:
        assert r[0] == got[0][0]
        assert all(np.array_equal(r[1][n], got[0][1][n]) for n in want_p)


def test_remat_at_mp2_is_bitwise_plain(reference):
    """remat=True at mp = 2 replays each layer's collectives in the
    backward (the CPU ranks' own threads): bitwise remat=False's steps."""
    init = reference[0]
    plain = _train(MESHES["mp2"], init, steps=2)
    remat = _train(MESHES["mp2"], init, remat=True, steps=2)
    for p, r in zip(plain, remat):
        assert p[0] == r[0]
        assert all(np.array_equal(p[1][n], r[1][n]) for n in p[1])


def test_shards_cut_and_join(reference):
    """shard_params with BERT's splits cuts qkv head-aligned (rank r: heads
    [2r, 2r + 2) of q, k and v) and mlm_bias by vocabulary range;
    full_params joins them back bitwise, and every parameter's DistAttr
    is the reference's."""
    init = reference[0]
    parts = [shard_params(init, 2, r, splits=BERT_MP_SPLITS)
             for r in range(2)]
    q = init["qkv_w"][:, :, :64].reshape(2, 64, 4, 16)
    assert np.array_equal(parts[1]["qkv_w"][:, :, :32].numpy(),
                          q[:, :, 2:].reshape(2, 64, 32))
    assert tuple(parts[0]["mlm_bias"].shape) == (128,)
    joined = full_params(parts, splits=BERT_MP_SPLITS)
    assert all(np.array_equal(joined[n].numpy(), init[n]) for n in init)
    ref = jbert.Bert(jbert.bert_tiny(**CFG))
    port = Bert(bert_tiny(**CFG), device="cpu")
    for n in _PARAM_ORDER:
        want = getattr(ref._parameters[n], "dist_attr", None)
        got = getattr(getattr(port, n), "dist_attr", None)
        assert (None if want is None else tuple(want.spec)) == \
            (None if got is None else got.spec), n


def test_sp_and_pp_axes_keep_a_replica(reference):
    """The reference's Bert strips sp and has no pipeline: on an sp or pp
    axis every rank holds the whole model and one SGD step's loss is the
    one-rank loss; heads that do not divide over mp raise."""
    init, (loss0, *_) = reference[:2]
    batch = [torch.from_numpy(a) for a in _batch()]
    from paddle_tpu_torch.optimizer import SGD

    def fn(rank, mesh):
        model = Bert(bert_tiny(**CFG), device="cpu").load_jax_params(init)
        assert tuple(model.wte.shape) == (256, 64)
        return float(ShardedTrainStep(model, _loss, SGD(learning_rate=0.0),
                                      mesh=mesh)(*batch))
    for axes in ({"sp": 2}, {"pp": 2}):
        for got in LoopbackWorld(2).run(fn, axes=axes):
            np.testing.assert_allclose(got, loss0, rtol=TOL)

    def bad(rank, mesh):
        with pytest.raises(ValueError, match="num_heads=3"):
            Bert(bert_tiny(num_heads=3, hidden_size=48), device="cpu")
        return True
    assert LoopbackWorld(2).run(bad, axes={"mp": 2}) == [True, True]
