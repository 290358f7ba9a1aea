"""Port fused linear + cross-entropy (paddle_tpu_torch.ops.cuda.fused_ce)
against the reference Pallas kernel run in interpret mode on the CPU.

The same numpy inputs go through both; on the CPU the port's wrapper runs
its plain PyTorch version.  Tolerance: 1e-5 absolute in f32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_ce as jce
from paddle_tpu_torch.ops.cuda import fused_ce as tce

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    jce._INTERPRET = True
    yield
    jce._INTERPRET = False


def _inputs(n, h, v, seed=0):
    rng = np.random.default_rng(seed)
    hs = rng.standard_normal((n, h)).astype(np.float32)
    w = (rng.standard_normal((v, h)) * 0.05).astype(np.float32)
    lab = rng.integers(0, v, size=(n,)).astype(np.int32)
    lab[::7] = -1                                 # padding sentinels
    return hs, w, lab


# V=1000 is not a multiple of 128 (the reference pads W and masks by iota);
# N=300 is not a multiple of 128 (the reference pads the token axis)
@pytest.mark.parametrize("n,h,v", [(256, 256, 1000), (300, 256, 1000)])
def test_forward_matches_interpret_kernel(n, h, v):
    hs, w, lab = _inputs(n, h, v)
    ref = jce.fused_linear_cross_entropy(jnp.asarray(hs), jnp.asarray(w),
                                         jnp.asarray(lab))
    with torch.no_grad():
        out = tce.fused_linear_cross_entropy(
            torch.from_numpy(hs), torch.from_numpy(w), torch.from_numpy(lab))
    assert out.dtype == torch.float32 and out.shape == (n,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_logz_matches_interpret_kernel():
    hs, w, _ = _inputs(256, 256, 1000, seed=1)
    w_pad = jce._pad_w(jnp.asarray(w))
    ref = jce._ce_logz(jnp.asarray(hs), w_pad, 1000)[:, 0]
    out = tce.ce_logz(torch.from_numpy(hs), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_fused_matches_unfused_reference():
    hs, w, lab = _inputs(300, 128, 777, seed=2)
    args = (torch.from_numpy(hs), torch.from_numpy(w), torch.from_numpy(lab))
    np.testing.assert_allclose(tce.fused_linear_cross_entropy(*args).numpy(),
                               tce.xla_reference(*args).numpy(), atol=ATOL,
                               rtol=0)


def test_empty_batch():
    w = torch.zeros(10, 128)
    out = tce.fused_linear_cross_entropy(torch.zeros(0, 128), w,
                                         torch.zeros(0, dtype=torch.long))
    assert out.shape == (0,)


@pytest.mark.parametrize("which", ["h", "w"])
def test_gradient_request_raises(which):
    hs, w, lab = _inputs(128, 128, 300)
    h_t, w_t = torch.from_numpy(hs), torch.from_numpy(w)
    (h_t if which == "h" else w_t).requires_grad_()
    with pytest.raises(NotImplementedError, match="backward: next slice"):
        tce.fused_linear_cross_entropy(h_t, w_t, torch.from_numpy(lab))
    with torch.no_grad():                         # a scoring call is fine
        tce.fused_linear_cross_entropy(h_t, w_t, torch.from_numpy(lab))


def test_supported_follows_reference_rule():
    jce._INTERPRET = True
    for n, h in [(0, 128), (300, 256), (8192, 1024), (300, 100)]:
        assert tce.supported(n, h) is jce.supported(n, h)


def test_vocab_split_covers_every_tile():
    # the CUDA grid splits the vocabulary into k runs of ceil(tiles / k)
    # tiles; together they must cover every tile
    for dtype, (_, block_v) in tce._BLOCKS.items():
        for n, v in [(8192, 50304), (64, 1000), (300, 64), (10, 5)]:
            k = tce._n_split(n, v, dtype)
            n_vt = -(-v // block_v)
            assert 1 <= k <= n_vt
            assert k * -(-n_vt // k) >= n_vt


def test_other_devices_raise():
    h = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tce.ce_logz(h, h)
