"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.  CUDA kernels have no CPU mode, so without a card these tests
skip.  On a machine with one:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest

Tolerances: f32 outputs 1e-4 (summation order only); bf16 outputs 2e-2
(a few bf16 ulps of O(1) values); f32 lse / logz from bf16 inputs 1e-3.
bf16 gradients: max |got - want| / (|want| + rms(want)) per tensor at most
0.1, the measure and limit of chip_smoke.py.  Both sides round to bf16, so
an entry may differ by an ulp of itself; the rms floor keeps an error among
the many small gradients from hiding behind the few large ones
(tests/test_torch_flash_attention.py shows the limit flags a dropped tile or
fragment).
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


TOL_GRAD_BF16 = 0.1


def _close_grad(a, b, tol):
    a, b = a.float().cpu(), b.float().cpu()
    assert bool(torch.isfinite(a).all())
    rms = b.pow(2).mean().sqrt()
    assert float(((a - b).abs() / (b.abs() + rms)).max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (256, 256, 64, True), (200, 200, 128, True), (128, 384, 64, True),
    (300, 300, 64, False), (256, 256, 128, False), (256, 128, 64, True)])
def test_flash_bwd_kernels_match_plain(gen, dtype, sq, sk, d, causal):
    qt = _rand(gen, (6, sq, d), dtype)
    kt, vt = _rand(gen, (6, sk, d), dtype), _rand(gen, (6, sk, d), dtype)
    dot = _rand(gen, (6, sq, d), dtype)
    scale = 1.0 / math.sqrt(d)
    ot, lse = fa.flash_attention_reference(qt, kt, vt, scale, causal)
    before = (fa.launches_dq, fa.launches_dkv)
    got = fa._launch_bwd(qt, kt, vt, ot, lse, dot, scale, causal)
    want = fa.flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot, scale,
                                            causal)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1,
                                                 before[1] + 1)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.bfloat16:
            _close_grad(g, w, TOL_GRAD_BF16)
        else:
            _close(g, w, 1e-4)
    if sq > sk and causal:               # rows with no key: zero dq
        assert float(got[0][:, :sq - sk].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_card_matches_plain(gen, dtype):
    q, k, v = (_rand(gen, (2, 256, 4, 64), dtype).requires_grad_()
               for _ in range(3))
    w = _rand(gen, (2, 256, 4, 64), dtype)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    (fa.flash_attention(q, k, v, causal=True) * w).sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == tuple(
        n + 1 for n in before)
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    (fa.flash_attention(qc, kc, vc, causal=True) * w.cpu()).sum().backward()
    for g, c in zip((q.grad, k.grad, v.grad), (qc.grad, kc.grad, vc.grad)):
        if dtype == torch.bfloat16:
            _close_grad(g, c, TOL_GRAD_BF16)
        else:
            _close(g, c, 1e-4)


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
