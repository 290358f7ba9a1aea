"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.  CUDA kernels have no CPU mode, so without a card these tests
skip.  On a machine with one:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest

Tolerances: f32 outputs 1e-4 (summation order only); bf16 outputs 2e-2
(a few bf16 ulps of O(1) values); f32 lse / logz from bf16 inputs 1e-3.
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import fused_ce

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(g, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _close(a, b, tol):
    a, b = a.float().cpu(), b.float().cpu()
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    fin = torch.isfinite(a)
    assert torch.equal(a[~fin], b[~fin])
    if fin.any():
        assert float((a[fin] - b[fin]).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (256, 256, 64, True), (200, 200, 128, True), (128, 384, 64, True),
    (300, 300, 64, False), (256, 128, 64, True)])
def test_flash_kernel_matches_plain(gen, dtype, sq, sk, d, causal):
    qt = _rand(gen, (6, sq, d), dtype)
    kt, vt = _rand(gen, (6, sk, d), dtype), _rand(gen, (6, sk, d), dtype)
    scale = 1.0 / math.sqrt(d)
    before = fa.launches
    out, lse = fa._launch(qt, kt, vt, scale, causal)
    out_p, lse_p = fa.flash_attention_reference(qt, kt, vt, scale, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    bf16 = dtype == torch.bfloat16
    _close(out, out_p, 2e-2 if bf16 else 1e-4)
    _close(lse, lse_p, 1e-3 if bf16 else 1e-4)


def test_flash_kernel_rejects_what_it_does_not_take(gen):
    q = _rand(gen, (2, 128, 2, 96), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, causal=True)
    q = _rand(gen, (2, 128, 2, 64), torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,v", [(256, 256, 1000), (300, 128, 777),
                                   (1, 128, 64)])
def test_ce_kernel_matches_plain(gen, dtype, n, h, v):
    hs = _rand(gen, (n, h), dtype)
    w = _rand(gen, (v, h), dtype, 0.05)
    before = fused_ce.launches
    logz = fused_ce._launch(hs, w)
    torch.cuda.synchronize()
    assert fused_ce.launches == before + 1
    _close(logz, fused_ce.ce_logz_reference(hs, w),
           1e-3 if dtype == torch.bfloat16 else 1e-4)


def test_ce_kernel_rejects_what_it_does_not_take(gen):
    hs = _rand(gen, (64, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        fused_ce.ce_logz(hs, _rand(gen, (100, 256), torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fused_ce.ce_logz(hs.T, hs)
