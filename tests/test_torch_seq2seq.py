"""The port's encoder-decoder Transformer against the reference on the CPU,
d_model 128, 2 heads of 64, target S = 128 over a source of 256:

- ``TransformerDecoderLayer`` (post-norm and pre-norm) and a 2-layer
  ``TransformerDecoder`` under the decoder's two masks, the (128, 128)
  causal bias of ``generate_square_subsequent_mask`` and a (B, 1, 1, 256)
  padding bias over the memory: output 1e-5, every gradient (the target's
  and the memory's included) 1e-4, absolute; once with the reference's
  attention on its Pallas kernel in interpret mode (cross-attention
  Sq != Sk under the bias row, and the full 2-D causal bias), else on its
  dense path; the port takes its flash path's plain versions either way;
- ``Transformer.forward`` with all three masks, and the mask itself;
- the incremental decode: ``gen_cache`` and 16 single-token calls equal
  the full causal forward on the same tokens (1e-5) and the reference's
  own incremental decode;
- the composition of ``torch_seq2seq_common`` trained by ``TrainStep``:
  two f32 steps (Adam(beta2=0.98, epsilon=1e-9) under ``NoamDecay``, the
  label-smoothed soft-label loss, dropout 0), losses and parameters 1e-5
  (parameters where the first gradient is above rounding noise; the
  test says why);
  two O2 bf16 steps, losses within ``test_torch_train.py``'s 2e-2;
- the incremental cache keeps a bf16 model's dtype.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.optimizer import lr as tlr

from torch_seq2seq_common import batch, j_loss, named, pair, t_loss

ATOL = 1e-5
ATOL_GRAD = 1e-4
ATOL_O2_LOSS = 2e-2                 # test_torch_train.py's O2 tolerance
B, E, NH, FFN, SQ, SK = 2, 128, 2, 256, 128, 256


@pytest.fixture(autouse=True)
def _reference_env():
    """One mesh, and the reference's global generator seeded for each
    test and restored after it.  The reference draws its layers'
    initial weights from that generator, so without the seed they
    depend on which tests ran before in the process; some of those
    weights put a ReLU pre-activation of the decoder's first layer
    within f32 rounding of 0, where the two packages round to opposite
    sides of the kink and that unit's gradients differ by O(1)."""
    prev = get_mesh()
    state = paddle.get_rng_state()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    paddle.seed(0)
    yield
    jfa._INTERPRET = False
    paddle.set_rng_state(state)
    set_mesh(prev)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal((B, SQ, E)).astype(np.float32)
    mem = rng.standard_normal((B, SK, E)).astype(np.float32)
    w = rng.standard_normal((B, SQ, E)).astype(np.float32)
    return tgt, mem, w, batch(seed)[3]


def _causal(n):
    return np.array(jnn.Transformer.generate_square_subsequent_mask(n)
                    ._data)


def _run(ref, port, seed):
    """Forward both decoders on the same target, memory and masks;
    backward sum(out * w); compare outputs and every gradient."""
    tgt, mem, w, bias = _inputs(seed)
    jt, jm = (paddle.to_tensor(a, stop_gradient=False) for a in (tgt, mem))
    out_j = ref(jt, jm, paddle.to_tensor(_causal(SQ)), paddle.to_tensor(bias))
    (out_j * paddle.to_tensor(w)).sum().backward()
    tt, tm = (torch.from_numpy(a).requires_grad_() for a in (tgt, mem))
    before = (tfa.launches_masked, tfa.launches_dq_masked)
    out_t = port(tt, tm, tnn.Transformer.generate_square_subsequent_mask(
        SQ, device="cpu"), torch.from_numpy(bias))
    (out_t * torch.from_numpy(w)).sum().backward()
    assert (tfa.launches_masked, tfa.launches_dq_masked) == before
    np.testing.assert_allclose(out_t.detach().numpy(),
                               np.asarray(out_j._data), atol=ATOL, rtol=0)
    for n, p in ref.named_parameters():
        np.testing.assert_allclose(dict(port.named_parameters())[n].grad
                                   .numpy(), np.asarray(p.grad._data),
                                   atol=ATOL_GRAD, rtol=0, err_msg=n)
    for a, b, what in ((tt, jt, "dtgt"), (tm, jm, "dmemory")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b.grad._data),
                                   atol=ATOL_GRAD, rtol=0, err_msg=what)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_matches_reference(normalize_before):
    ref = jnn.TransformerDecoderLayer(E, NH, FFN, dropout=0.0,
                                      normalize_before=normalize_before)
    port = tnn.TransformerDecoderLayer(E, NH, FFN, dropout=0.0,
                                       normalize_before=normalize_before,
                                       device="cpu")
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    _run(ref, load_named_params(port, named(ref)), 1)


@pytest.mark.parametrize("interpret", [False, True])
def test_decoder_matches_reference(interpret):
    """Interpret: the reference's cross-attention (Sq 128, Sk 256, a
    (B, 1, 1, 256) bias) and self-attention (a (128, 128) bias) run its
    Pallas kernel."""
    jfa._INTERPRET = interpret
    ref = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        E, NH, FFN, dropout=0.0), 2, jnn.LayerNorm(E))
    port = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        E, NH, FFN, dropout=0.0, device="cpu"), 2, tnn.LayerNorm(
            E, device="cpu"))
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    for q, k in ((SQ, SQ), (SQ, SK)):
        bias = (SQ, SQ) if k == SQ else (B, 1, 1, SK)
        assert jfa.supported((B, q, NH, E // NH), (B, k, NH, E // NH),
                             False, bias_shape=bias) == interpret
        assert tfa.supported((B, q, NH, E // NH), (B, k, NH, E // NH),
                             False, bias_shape=bias, dtype=torch.float32)
    _run(ref, load_named_params(port, named(ref)), 2)


def test_square_subsequent_mask_matches_reference():
    got = tnn.Transformer.generate_square_subsequent_mask(7, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), _causal(7))
    assert got[0, 1] == -1e9 and got[6, 0] == 0


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_forward_matches_reference(normalize_before):
    ref = jnn.Transformer(E, NH, 2, 2, FFN, dropout=0.0,
                          normalize_before=normalize_before)
    port = tnn.Transformer(E, NH, 2, 2, FFN, dropout=0.0,
                           normalize_before=normalize_before, device="cpu")
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    load_named_params(port, named(ref))
    tgt, mem, _, bias = _inputs(3)
    src_mask = np.ascontiguousarray(bias)
    want = ref(paddle.to_tensor(mem), paddle.to_tensor(tgt),
               paddle.to_tensor(src_mask), paddle.to_tensor(_causal(SQ)),
               paddle.to_tensor(bias))
    got = port(torch.from_numpy(mem), torch.from_numpy(tgt),
               torch.from_numpy(src_mask),
               tnn.Transformer.generate_square_subsequent_mask(
                   SQ, device="cpu"), torch.from_numpy(bias))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               atol=ATOL, rtol=0)


def test_custom_encoder_and_decoder_are_kept():
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, NH, FFN, device="cpu"), 1)
    dec = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        E, NH, FFN, device="cpu"), 1)
    t = tnn.Transformer(E, NH, custom_encoder=enc, custom_decoder=dec,
                        device="cpu")
    assert t.encoder is enc and t.decoder is dec


def test_incremental_decode_equals_full_forward():
    """gen_cache, then one token a call: each step's output is the full
    causal forward's row (the port), and the reference's own step."""
    steps = 16
    ref = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        E, NH, FFN, dropout=0.0), 2)
    port = load_named_params(tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(E, NH, FFN, dropout=0.0, device="cpu"),
        2), named(ref))
    tgt, mem, _, bias = _inputs(4)
    tgt = tgt[:, :steps]
    with torch.no_grad():
        tt, tm, tb = (torch.from_numpy(a) for a in (tgt, mem, bias))
        full = port(tt, tm, tnn.Transformer.generate_square_subsequent_mask(
            steps, device="cpu"), tb).numpy()
        cache = port.gen_cache(tm)
        zipped = port.gen_cache(tm, do_zip=True)
        assert len(zipped) == 2 and len(zipped[0]) == 2
        assert isinstance(zipped[1][0], tnn.MultiHeadAttention.StaticCache)
        jcache = ref.gen_cache(paddle.to_tensor(mem))
        for t in range(steps):
            out, cache = port(tt[:, t:t + 1], tm, None, tb, cache)
            jout, jcache = ref(paddle.to_tensor(tgt[:, t:t + 1]),
                               paddle.to_tensor(mem), None,
                               paddle.to_tensor(bias), jcache)
            np.testing.assert_allclose(out.numpy()[:, 0], full[:, t],
                                       atol=ATOL, rtol=0, err_msg=str(t))
            np.testing.assert_allclose(out.numpy(), np.asarray(jout._data),
                                       atol=ATOL, rtol=0, err_msg=str(t))
        assert tuple(cache[0][0].k.shape) == (B, steps, NH, E // NH)
        assert tuple(cache[1][1].k.shape) == (B, SK, NH, E // NH)


def test_incremental_cache_keeps_a_bf16_models_dtype():
    """The reference starts the cache f32 and its concat promotes a bf16
    model's keys; the port's cache stays in the weights' dtype."""
    port = tnn.TransformerDecoderLayer(E, NH, FFN, dropout=0.0,
                                       device="cpu").to(torch.bfloat16)
    mem = torch.randn(B, SK, E).bfloat16()
    incr, static = port.gen_cache(mem)
    assert incr.k.dtype == static.k.dtype == torch.bfloat16
    out, (incr, _) = port(torch.randn(B, 1, E).bfloat16(), mem, None, None,
                          (incr, static))
    assert out.dtype == incr.k.dtype == torch.bfloat16
    ref = jnn.TransformerDecoderLayer(E, NH, FFN, dropout=0.0)
    assert ref.gen_cache(paddle.to_tensor(mem.float().numpy()))[0].k.dtype \
        == paddle.float32


LR_BASE, WARMUP = 1.0, 10           # Noam's rate moves the small model
GRAD_FLOOR = 1e-4                   # f32 gradient noise is ~1e-7


def _train_inputs(seed):
    src, tgt, label, bias = batch(seed)
    return src, tgt, label, bias, _causal(SQ), bias


def _reference_steps(ref, amp_level, steps):
    sched = jlr.NoamDecay(E, WARMUP, learning_rate=LR_BASE)
    opt = jopt.Adam(learning_rate=sched, beta2=0.98, epsilon=1e-9,
                    parameters=ref.parameters())
    step = JTrainStep(ref, j_loss, opt, amp_level=amp_level,
                      amp_dtype="bfloat16")
    losses = []
    for _ in range(steps):
        losses.append(float(step(*(paddle.to_tensor(a)
                                   for a in _train_inputs(5)))))
        sched.step()
    return losses, named(ref)


def _port_steps(port, amp_level, steps):
    sched = tlr.NoamDecay(E, WARMUP, learning_rate=LR_BASE)
    step = TrainStep(port, t_loss, Adam(learning_rate=sched, beta2=0.98,
                                        epsilon=1e-9),
                     amp_level=amp_level, amp_dtype="bfloat16")
    losses = []
    for _ in range(steps):
        losses.append(float(step(*(torch.from_numpy(a)
                                   for a in _train_inputs(5)))))
        sched.step()
    return losses


def test_f32_train_steps_match_reference():
    """Losses 1e-5; parameters 1e-5 wherever the first gradient is above
    GRAD_FLOOR.  Below it Adam divides rounding noise by its own size (the
    key projections' biases take an exactly zero gradient, softmax being
    blind to a shift of every key's score): there each package's move must
    stay within Adam's bound, the sum of the step rates."""
    ref, port = pair()
    init = named(ref)
    inputs = [torch.from_numpy(a) for a in _train_inputs(5)]
    t_loss(port, *inputs).backward()
    grads = {n: p.grad.abs().numpy() for n, p in port.named_parameters()}
    port.zero_grad()
    want, want_params = _reference_steps(ref, None, 2)
    got = _port_steps(port, None, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert abs(want[0] - np.log(512)) < 0.5
    sched = tlr.NoamDecay(E, WARMUP, learning_rate=LR_BASE)
    rates = sched()
    sched.step()
    rates += sched()
    conditioned = 0
    for n, p in port.named_parameters():
        p = p.detach().numpy()
        sel = grads[n] > GRAD_FLOOR
        conditioned += int(sel.sum())
        np.testing.assert_allclose(p[sel], want_params[n][sel], atol=ATOL,
                                   rtol=0, err_msg=n)
        for moved in (p - init[n], want_params[n] - init[n]):
            assert np.abs(moved).max() <= rates * 1.01, n
    assert conditioned > 0.5 * sum(g.size for g in grads.values())
    assert max(np.abs(want_params[n] - init[n]).max()
               for n in init) > 0.5 * rates   # the steps moved them


def test_o2_train_steps_match_reference():
    ref, port = pair()
    want, _ = _reference_steps(ref, "O2", 2)
    got = _port_steps(port, "O2", 2)
    np.testing.assert_allclose(got, want, atol=ATOL_O2_LOSS, rtol=0)
    assert port.head.weight.dtype == torch.float32
    assert not np.array_equal(port.head.weight.detach().numpy(),
                              named(pair()[0])["head.weight"])
