"""The port's BERT (paddle_tpu_torch.models.bert) against the reference JAX
model on the CPU, unpadded and on a padded batch.

SMALL (2 layers, hidden 128, 2 heads of 64, S = 128, V = 256) keeps both
packages on their flash path, masked calls included: the reference's
Pallas kernels in interpret mode, the port's plain versions on the CPU.
``bert_tiny`` (head dim 16) takes the dense path in both.  A single-device
mesh is pinned for the reference.  The same numpy draws give both models
their parameters and both steps their batches.

Tolerances: f32 logits, losses, gradients, parameters and moments 1e-4
absolute (the two sum in different orders); AMP O2 bf16 losses 2e-2 (bf16
rounding at different places).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (Bert, BertConfig, bert_pretrain_loss,
                                     bert_tiny)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW

ATOL = 1e-4
ATOL_O2_LOSS = 2e-2
LR = 1e-4                 # bench.py's AdamW rate
STEPS = 3
B = 2
SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128, remat=False)
TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=128, remat=False)          # bert_tiny's widths
KEYS = ("moment1", "moment2")


@pytest.fixture(autouse=True)
def _reference_env():
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False
    set_mesh(prev)


def _batch(seed, padded, vocab=256, s=128):
    """(ids, mlm labels, nsp labels, attention mask or None), drawn as
    bench.py draws them: 15 % MLM labels, lengths in [S/2, S] when
    padded, labels -100 on the padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, s)).astype(np.int32)
    mlm = np.where(rng.random((B, s)) < 0.15, ids, -100).astype(np.int32)
    nsp = rng.integers(0, 2, (B,)).astype(np.int32)
    if not padded:
        return ids, mlm, nsp, None
    lens = rng.integers(s // 2, s + 1, (B,))
    amask = np.arange(s)[None, :] < lens[:, None]
    return (ids, np.where(amask, mlm, -100).astype(np.int32), nsp,
            amask.astype(np.int32))


def _args(batch, to):
    return [to(a) for a in batch if a is not None]


def _np_params(model):
    return {n: np.array(model._parameters[n]._data)
            for n in jbert._PARAM_ORDER}


def _pair(cfg_kw):
    ref = jbert.Bert(jbert.BertConfig(**cfg_kw))
    port = Bert(BertConfig(**cfg_kw), device="cpu").load_jax_params(
        _np_params(ref))
    return ref, port


def test_initial_parameters_are_the_reference_draws():
    ref = jbert.Bert(jbert.BertConfig(**SMALL))
    port = Bert(BertConfig(**SMALL), device="cpu")
    assert [n for n, _ in port.named_parameters()] == list(
        jbert._PARAM_ORDER)
    for n, want in _np_params(ref).items():
        np.testing.assert_array_equal(getattr(port, n).detach().numpy(),
                                      want, err_msg=n)


@pytest.mark.parametrize("padded", [False, True])
def test_small_bert_takes_the_kernel_path(padded):
    cfg = BertConfig(**SMALL)
    bias = torch.zeros(B, 1, 1, 128) if padded else None
    assert tbert._flash_ok(cfg, B, 128, bias)
    shape = (B, 128, 2, 64)
    assert jfa.supported(shape, shape, not padded,
                         bias_shape=(B, 1, 1, 128) if padded else None)


@pytest.mark.parametrize("padded", [False, True])
def test_logits_loss_and_gradients_match_reference(padded):
    ref, port = _pair(SMALL)
    batch = _batch(0, padded)
    amask = batch[3]
    mlm_j, nsp_j = ref(paddle.to_tensor(batch[0]),
                       attention_mask=None if amask is None
                       else paddle.to_tensor(amask))
    want = jbert.bert_pretrain_loss(ref, *_args(batch, paddle.to_tensor))
    want.backward()
    before = (tfa.launches, tfa.launches_masked, tfa.launches_dbias)
    mlm_t, nsp_t = port(batch[0], attention_mask=amask)
    got = bert_pretrain_loss(port, *_args(batch, torch.from_numpy))
    got.backward()
    assert (tfa.launches, tfa.launches_masked, tfa.launches_dbias) == before
    np.testing.assert_allclose(mlm_t.detach().numpy(), np.asarray(
        mlm_j._data), atol=ATOL, rtol=0)
    np.testing.assert_allclose(nsp_t.detach().numpy(), np.asarray(
        nsp_j._data), atol=ATOL, rtol=0)
    assert abs(got.item() - float(want)) <= ATOL
    for n in jbert._PARAM_ORDER:
        g = getattr(port, n).grad
        assert g is not None and g.shape == getattr(port, n).shape, n
        np.testing.assert_allclose(
            g.numpy(), np.asarray(ref._parameters[n].grad._data),
            atol=ATOL, rtol=0, err_msg=n)


def test_padding_changes_the_real_tokens_logits_only_through_the_mask():
    # an all-ones mask is the unmasked model; a padded batch differs
    _, port = _pair(SMALL)
    ids, _, _, amask = _batch(1, True)
    with torch.no_grad():
        plain = port(ids)[0]
        ones = port(ids, attention_mask=np.ones_like(amask))[0]
        padded = port(ids, attention_mask=amask)[0]
    torch.testing.assert_close(ones, plain, atol=1e-5, rtol=0)
    assert not torch.allclose(padded, plain, atol=1e-3)


def _reference_run(padded, amp_level):
    """STEPS reference TrainStep steps on one fixed batch, as bench.py
    trains: the initial parameters, then (loss, parameters, moments) after
    each."""
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfa._INTERPRET = True
    try:
        ref = jbert.Bert(jbert.BertConfig(**SMALL))
        init = _np_params(ref)
        opt = jopt.AdamW(learning_rate=LR, parameters=ref.parameters())
        step = JTrainStep(ref, jbert.bert_pretrain_loss, opt,
                          amp_level=amp_level, amp_dtype="bfloat16")
        args = _args(_batch(10, padded), paddle.to_tensor)
        after = []
        for _ in range(STEPS):
            loss = float(step(*args))
            states = {n: {k: np.array(st[k]) for k in KEYS}
                      for n, st in step._opt_states.items()}
            after.append((loss, _np_params(ref), states))
        return init, after
    finally:
        jfa._INTERPRET = False
        set_mesh(prev)


@pytest.fixture(scope="module", params=[False, True],
                ids=["unpadded", "padded"])
def ref_f32(request):
    return request.param, _reference_run(request.param, None)


def _port_run(init, padded, amp_level=None):
    model = Bert(BertConfig(**SMALL), device="cpu").load_jax_params(init)
    step = TrainStep(model, bert_pretrain_loss, AdamW(learning_rate=LR),
                     amp_level=amp_level, amp_dtype="bfloat16")
    args = _args(_batch(10, padded), torch.from_numpy)
    losses = [float(step(*args)) for _ in range(STEPS)]
    return model, step, losses


def test_f32_train_steps_match_reference(ref_f32):
    padded, (init, after) = ref_f32
    model, step, losses = _port_run(init, padded)
    np.testing.assert_allclose(losses, [a[0] for a in after], atol=ATOL,
                               rtol=0)
    assert losses[-1] < losses[0]
    _, want_params, want_states = after[-1]
    for n in jbert._PARAM_ORDER:
        got = getattr(model, n).detach().numpy()
        np.testing.assert_allclose(got, want_params[n], atol=ATOL, rtol=0,
                                   err_msg=n)
        # each parameter moved ~3e-4; its move agrees to 1 % of that
        moved = np.abs(want_params[n] - init[n]).max()
        assert np.abs(got - want_params[n]).max() <= 1e-2 * moved, n
    assert set(step._opt_states) == set(want_states)
    for n, st in step._opt_states.items():
        for k in KEYS:
            np.testing.assert_allclose(st[k].numpy(), want_states[n][k],
                                       atol=ATOL, rtol=0, err_msg=f"{n} {k}")


def test_o2_bf16_losses_match_reference():
    init, after = _reference_run(True, "O2")
    model, _, losses = _port_run(init, True, amp_level="O2")
    np.testing.assert_allclose(losses, [a[0] for a in after],
                               atol=ATOL_O2_LOSS, rtol=0)
    assert model.wte.dtype == torch.float32
    assert not np.array_equal(model.wte.detach().numpy(), init["wte"])


@pytest.mark.parametrize("padded", [False, True])
def test_bert_tiny_takes_the_dense_path(padded):
    # head dim 16: the kernel's rule sends both packages to dense attention
    cfg = bert_tiny(remat=False)
    assert cfg.head_dim == 16
    assert not tbert._flash_ok(cfg, B, 128,
                               torch.zeros(B, 1, 1, 128) if padded else None)
    ref, port = _pair(TINY)
    batch = _batch(2, padded)
    want = jbert.bert_pretrain_loss(ref, *_args(batch, paddle.to_tensor))
    want.backward()
    got = bert_pretrain_loss(port, *_args(batch, torch.from_numpy))
    got.backward()
    assert abs(got.item() - float(want)) <= ATOL
    for n in ("wte", "qkv_w", "prj_w", "mlm_bias", "nsp_w"):
        np.testing.assert_allclose(
            getattr(port, n).grad.numpy(),
            np.asarray(ref._parameters[n].grad._data), atol=ATOL, rtol=0,
            err_msg=n)


def test_ernie_is_bert():
    from paddle_tpu_torch.models import Ernie, ErnieConfig
    assert Ernie is Bert and ErnieConfig is BertConfig


def test_bert_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Bert(bert_tiny())
    assert Bert(bert_tiny(), device="cpu").wte.device.type == "cpu"
