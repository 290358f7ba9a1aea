"""Port flash attention (paddle_tpu_torch.ops.cuda.flash_attention) against
the reference Pallas kernels run in interpret mode on the CPU, forward and
backward.

The same numpy inputs go through both.  On the CPU the port's wrapper runs
its plain PyTorch versions; the CUDA kernels themselves are held to those
plain versions on the card by chip_smoke.py and
tests/test_torch_cuda_kernels.py.  Tolerances: 2e-5 absolute on f32
outputs, 1e-4 absolute on f32 gradients (the two sum in different orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import _xla_attention as jax_dense
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.nn.functional.attention import _xla_attention
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

ATOL = 2e-5
ATOL_GRAD = 1e-4


@pytest.fixture(autouse=True)
def _interpret():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _qkv(sq, sk, d, seed=0, b=1, h=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_interpret_kernel(causal, s, d):
    q, k, v = _qkv(s, s, d)
    scale = 1.0 / np.sqrt(d)
    out_j, lse_j = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), None, None, None, scale,
                                  causal)
    with torch.no_grad():
        out_t, lse_t = tfa.flash_attention_fwd(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, scale=scale)
    assert out_t.shape == q.shape and lse_t.shape == (2, s)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               atol=ATOL, rtol=0)


def test_rows_with_no_visible_key_match_kernel():
    # causal with more queries than keys: the first sq - sk rows see no key;
    # the kernel writes out = 0 and lse = -inf there
    q, k, v = _qkv(256, 128, 64, seed=3)
    out_j, lse_j = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), None, None, None, 0.125,
                                  True)
    out_t, lse_t = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, scale=0.125)
    assert np.all(out_t.numpy()[:, :128] == 0)
    assert np.all(np.isneginf(lse_t.numpy()[:, :128]))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(np.isneginf(lse_t.numpy()),
                                  np.isneginf(np.asarray(lse_j)[..., 0]))


@pytest.mark.parametrize("causal", [True, False])
def test_dense_fallback_matches_reference(causal):
    q, k, v = _qkv(64, 64, 64, seed=1)
    ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                    0.125, causal)
    out = _xla_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), None, 0.125, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("q_shape,k_shape,causal,want", [
    ((2, 128, 4, 64), (2, 128, 4, 64), True, True),
    ((2, 64, 4, 64), (2, 64, 4, 64), True, False),      # S < 128: dense
    ((2, 256, 4, 64), (2, 128, 4, 64), True, False),    # causal sq > sk
    ((2, 256, 4, 100), (2, 256, 4, 100), False, False),
    ((2, 256, 4, 256), (2, 256, 4, 256), False, True),
])
def test_supported_follows_reference_rule(q_shape, k_shape, causal, want):
    assert tfa.supported(q_shape, k_shape, causal) is want
    jfa._INTERPRET = True                # the reference rule, sans backend
    assert jfa.supported(q_shape, k_shape, True, causal=causal) is want


def _jax_grads(q, k, v, w, causal, scale):
    """jax.grad of sum(flash_attention(q, k, v) * w): the vjp with do = w,
    through the reference's _bwd_dq_kernel and _bwd_dkv_kernel."""
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal,
                                           scale=scale) * w)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, w, causal, scale):
    """The same vjp through the port's autograd Function."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal, scale=scale)
    (out * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_interpret_kernel(causal, s, d):
    q, k, v = _qkv(s, s, d, seed=5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    want = _jax_grads(q, k, v, w, causal, scale)
    # the autograd path
    for name, got, ref in zip("qkv", _port_grads(q, k, v, w, causal, scale),
                              want):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATOL_GRAD, rtol=0,
                                   err_msg=f"d{name}")
    # the plain backward on the folded residuals of the forward
    qt, kt, vt = (tfa._fold(torch.from_numpy(a)) for a in (q, k, v))
    ot, lse = tfa.flash_attention_reference(qt, kt, vt, scale, causal)
    dot = tfa._fold(torch.from_numpy(w))
    grads = tfa.flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot,
                                              scale, causal)
    for name, got, ref in zip("qkv", grads, want):
        np.testing.assert_allclose(tfa._unfold(got, 1, 2).numpy(), ref,
                                   atol=ATOL_GRAD, rtol=0,
                                   err_msg=f"d{name}")


def test_rows_with_no_visible_key_get_zero_gradients():
    # causal, sq > sk: the first sq - sk query rows see no key; their dq
    # is 0 and they add nothing to dk, dv
    q, k, v = _qkv(256, 128, 64, seed=7)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    got = _port_grads(q, k, v, w, True, 0.125)
    want = _jax_grads(q, k, v, w, True, 0.125)
    assert np.all(got[0][:, :128] == 0)
    for name, g, ref in zip("qkv", got, want):
        np.testing.assert_allclose(g, ref, atol=ATOL_GRAD, rtol=0,
                                   err_msg=f"d{name}")
    # the same dk, dv as attention over the rows that do see a key
    sub = _port_grads(q[:, 128:], k, v, w[:, 128:], True, 0.125)
    np.testing.assert_allclose(got[1], sub[1], atol=ATOL_GRAD, rtol=0)
    np.testing.assert_allclose(got[2], sub[2], atol=ATOL_GRAD, rtol=0)


def test_lse_output_is_not_differentiable():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(128, 128, 64))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert out.requires_grad and not lse.requires_grad


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode])
def test_nothing_recorded_without_grad(mode):
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(128, 128, 64))
    with mode():
        out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert not out.requires_grad and out.grad_fn is None
    want, _ = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(out, want.detach())


# The card check's measure of a bf16 gradient (chip_smoke.py and
# tests/test_torch_cuda_kernels.py): max |got - want| / (|want| + rms(want))
# per tensor, held to TOL_GRAD_BF16.  Faults a tiled kernel can make, put
# into the plain backward at the GPT-2 345M head shape, must read well
# above it; leaving p and ds unrounded must read below it.
TOL_GRAD_BF16 = 0.1


def _grad_err(a, b):
    a, b = a.float(), b.float()
    rms = b.pow(2).mean().sqrt()
    return float(((a - b).abs() / (b.abs() + rms)).max())


@pytest.fixture(scope="module")
def bf16_case():
    rng = np.random.default_rng(11)
    qt, kt, vt, dot = (torch.from_numpy(rng.standard_normal(
        (2, 1024, 64)).astype(np.float32)).bfloat16() for _ in range(4))
    ot, lse = tfa.flash_attention_reference(qt, kt, vt, 0.125, True)
    want = tfa.flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot, 0.125,
                                             True)
    s = tfa._scores(qt, kt, 0.125, True)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", dot.float(), vt.float())
    ds = (p * (dp - tfa._delta(dot, ot)[..., None])).bfloat16().float()
    return qt, kt, vt, ot, lse, dot, want, ds


def _fault(name, case):
    """(index into (dq, dk, dv), the gradient a faulty kernel would give)."""
    qt, kt, _, _, _, _, want, ds = case
    dq, dk, dv = (t.float().clone() for t in want)
    if name == "dq_misses_diagonal_key_tile":       # query tile 5
        ds = ds.clone()
        ds[:, 320:384, 320:384] = 0
        return 0, torch.einsum("bqk,bkd->bqd", ds, kt.float()) * 0.125
    if name == "dk_misses_tail_query_rows":         # last 24 rows
        ds = ds.clone()
        ds[:, 1000:] = 0
        return 1, torch.einsum("bqk,bqd->bkd", ds, qt.float()) * 0.125
    if name == "dk_tail_key_tile_unwritten":       # the last 64 keys
        dk[:, -64:] = 0
        return 1, dk
    if name == "dq_fragment_unwritten":             # one 64 x 8 fragment
        dq[:, 64:128, 8:16] = 0
        return 0, dq
    if name == "dv_fragment_unwritten":             # one 8 x 8 fragment
        dv[:, 500:508, :8] = 0
        return 2, dv
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "dq_misses_diagonal_key_tile", "dk_misses_tail_query_rows",
    "dk_tail_key_tile_unwritten", "dq_fragment_unwritten",
    "dv_fragment_unwritten"])
def test_bf16_gradient_measure_flags_faults(bf16_case, name):
    i, bad = _fault(name, bf16_case)
    assert _grad_err(bad.bfloat16(), bf16_case[6][i]) > 2 * TOL_GRAD_BF16


def test_bf16_gradient_measure_passes_rounding_control(bf16_case):
    # p and ds left in f32: the size of an honest rounding difference
    qt, kt, vt, ot, lse, dot, want, _ = bf16_case
    ctl = tfa.flash_attention_bwd_reference(
        *(t.float() for t in (qt, kt, vt, ot)), lse, dot.float(), 0.125, True)
    for c, w in zip(ctl, want):
        assert _grad_err(c.bfloat16(), w) < TOL_GRAD_BF16 / 2


def test_other_devices_raise():
    q = torch.empty(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_fwd(q, q, q, causal=True)


def test_cpu_path_counts_no_launch():
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(128, 128, 64))
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == before
