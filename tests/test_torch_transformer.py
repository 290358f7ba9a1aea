"""The port's transformer encoder layers (paddle_tpu_torch.nn) against the
reference JAX layers on the CPU: MultiHeadAttention and a 2-layer
TransformerEncoder (d_model 128, 2 heads of 64, S = 128, dropout 0), with
no mask, a bool padding mask, and a learned (1, 2, 128, 128) additive bias
that takes a gradient (the dbias path).

Both packages take their flash path: the reference's Pallas kernels in
interpret mode, the port's plain versions on the CPU.  The reference's
weights carry across by their ``named_parameters()`` names
(models.convert.load_named_params).  Tolerances: f32 outputs 2e-5 and
gradients 1e-4 absolute (the two sum in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.ops.pallas import flash_attention as jfa
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

ATOL = 2e-5
ATOL_GRAD = 1e-4
B, S, E, NH = 2, 128, 128, 2


@pytest.fixture(autouse=True)
def _interpret():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _named(layer):
    return {n: np.array(p._data) for n, p in layer.named_parameters()}


def _mask(kind, seed=3):
    """None, a (B, 1, 1, S) bool padding mask, or a (1, NH, S, S) f32
    bias."""
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "padding":
        lens = np.array([S, 77])
        return (np.arange(S)[None, :] < lens[:, None]).reshape(B, 1, 1, S)
    return (rng.standard_normal((1, NH, S, S)) * 0.5).astype(np.float32)


def _run(ref, port, x, w, kind, call):
    """Forward both with the same inputs and mask, backward sum(out * w);
    returns ((out, grads by name, dbias or None) for the reference, then
    the port)."""
    m = _mask(kind)
    learned = kind == "bias"
    jx = paddle.to_tensor(x, stop_gradient=False)
    jm = None if m is None else paddle.to_tensor(m,
                                                 stop_gradient=not learned)
    out_j = call(ref, jx, jm)
    (out_j * paddle.to_tensor(w)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tm = None if m is None else torch.from_numpy(m).requires_grad_(learned)
    out_t = call(port, tx, tm)
    (out_t * torch.from_numpy(w)).sum().backward()
    want = (np.asarray(out_j._data),
            {n: np.asarray(p.grad._data) for n, p in ref.named_parameters()},
            np.asarray(jx.grad._data),
            np.asarray(jm.grad._data) if learned else None)
    got = (out_t.detach().numpy(),
           {n: p.grad.numpy() for n, p in port.named_parameters()},
           tx.grad.numpy(), tm.grad.numpy() if learned else None)
    return want, got


def _compare(want, got):
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    assert set(got[1]) == set(want[1])
    for n in want[1]:
        np.testing.assert_allclose(got[1][n], want[1][n], atol=ATOL_GRAD,
                                   rtol=0, err_msg=n)
    np.testing.assert_allclose(got[2], want[2], atol=ATOL_GRAD, rtol=0,
                               err_msg="dx")
    if want[3] is not None:
        assert got[3].shape == want[3].shape
        np.testing.assert_allclose(got[3], want[3], atol=ATOL_GRAD, rtol=0,
                                   err_msg="dbias")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, E)).astype(np.float32),
            rng.standard_normal((B, S, E)).astype(np.float32))


@pytest.mark.parametrize("kind", ["none", "padding", "bias"])
def test_multi_head_attention_matches_reference(kind):
    ref = jnn.MultiHeadAttention(E, NH)
    port = load_named_params(tnn.MultiHeadAttention(E, NH, device="cpu"),
                             _named(ref))
    x, w = _inputs(1)
    before = (tfa.launches_masked, tfa.launches_dbias)
    _compare(*_run(ref, port, x, w, kind,
                   lambda m, x, mask: m(x, attn_mask=mask)))
    assert (tfa.launches_masked, tfa.launches_dbias) == before


@pytest.mark.parametrize("kind", ["none", "padding", "bias"])
def test_encoder_matches_reference(kind):
    ref = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        E, NH, 256, dropout=0.0, activation="gelu"), 2)
    port = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, NH, 256, dropout=0.0, activation="gelu", device="cpu"), 2)
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    load_named_params(port, _named(ref))
    x, w = _inputs(2)
    _compare(*_run(ref, port, x, w, kind, lambda m, x, mask: m(x, mask)))


def test_encoder_clones_are_fresh_parameters():
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, NH, 256, device="cpu"), 3)
    w = [layer.linear1.weight for layer in enc.layers]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    assert w[0].data_ptr() != w[1].data_ptr()
    with torch.no_grad():
        for layer in enc.layers[1:]:
            assert float(layer.linear1.bias.abs().max()) == 0.0
            assert float(layer.norm1.weight.min()) == 1.0


def test_incremental_cache_matches_full_attention():
    # a Cache grows by the keys of each call: attention over the
    # concatenation, as the reference's gen_cache / Cache path gives
    mha = tnn.MultiHeadAttention(E, NH, device="cpu")
    x = torch.from_numpy(_inputs(4)[0])
    cache = mha.gen_cache(x)
    assert cache.k.shape == (B, 0, NH, E // NH)
    out1, cache = mha(x[:, :64], cache=cache)
    out2, cache = mha(x[:, 64:], cache=cache)
    assert cache.k.shape == (B, S, NH, E // NH)
    static = mha.gen_cache(x, x, type=tnn.MultiHeadAttention.StaticCache)
    full, same = mha(x[:, 64:], x, x, cache=static)
    assert same is static
    torch.testing.assert_close(out2, full, atol=1e-5, rtol=0)


def test_dropout_draws_from_its_generator():
    x = torch.ones(64, 64)
    d = tnn.Dropout(0.5, generator=torch.Generator().manual_seed(7))
    a = d(x)
    d.generator = torch.Generator().manual_seed(7)
    assert torch.equal(a, d(x))
    assert set(a.unique().tolist()) == {0.0, 2.0}
    d.eval()
    assert torch.equal(d(x), x)


def test_param_attr_is_not_ported():
    """The name dates from before ParamAttr was ported; the test now
    checks the ported form: a str names the weight, and anything that is
    not an attr, an initializer, a name or False raises, as the
    reference's _to_attr does."""
    assert tnn.Linear(4, 4, weight_attr="w", device="cpu").weight.name == "w"
    with pytest.raises(TypeError, match="ParamAttr"):
        tnn.Linear(4, 4, weight_attr=object(), device="cpu")
    assert tnn.Linear(4, 4, bias_attr=False, device="cpu").bias is None


def test_layers_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tnn.TransformerEncoderLayer(E, NH, 256)
    with pytest.raises(RuntimeError, match="is_available"):
        tnn.LayerNorm(E)
