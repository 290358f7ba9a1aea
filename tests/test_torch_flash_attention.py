"""Port flash attention (paddle_tpu_torch.ops.cuda.flash_attention) against
the reference Pallas kernel run in interpret mode on the CPU.

The same numpy inputs go through both.  On the CPU the port's wrapper runs
its plain PyTorch version; the CUDA kernel itself is held to that plain
version on the card by chip_smoke.py and tests/test_torch_cuda_kernels.py.
Tolerance: 2e-5 absolute in f32 (the two sum in different orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import _xla_attention as jax_dense
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.nn.functional.attention import _xla_attention
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

ATOL = 2e-5


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


def test_gradient_request_raises():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(128, 128,
                                                                  64))
    with pytest.raises(NotImplementedError, match="backward: next slice"):
        tfa.flash_attention(q, k, v, causal=True)


def test_other_devices_raise():
    q = torch.empty(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_fwd(q, q, q, causal=True)


def test_cpu_path_counts_no_launch():
    before = tfa.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(128, 128, 64))
    tfa.flash_attention(q, k, v, causal=True)
    assert tfa.launches == before
