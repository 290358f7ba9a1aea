"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.  CUDA kernels have no CPU mode, so without a card these tests
skip.  On a machine with one:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest

Tolerances: f32 outputs 1e-4 (summation order only); bf16 outputs 2e-2
(a few bf16 ulps of O(1) values); f32 lse / logz from bf16 inputs 1e-3.
bf16 gradients: max |got - want| / (|want| + rms(want)) per tensor at most
0.1 for the flash backward, 0.05 for the flash dbias and 0.03 for the fused
CE backward, the measure and limits of chip_smoke.py.  Both sides round to
bf16, so an entry may differ by an ulp of itself; the rms floor keeps an
error among the many small gradients from hiding behind the few large ones
(tests/test_torch_flash_attention.py, tests/test_torch_flash_mask.py and
tests/test_torch_fused_ce.py show each limit flags a dropped tile, term or
fragment).  The fused Adam kernel repeats its plain version's f32
arithmetic: moments to 1e-6 relative, each parameter's move to 1e-3 of the
move; its bf16 instantiation is bitwise its plain version.  The row
quantizer is bitwise its plain codec (the scale and the
finite entries of rows holding NaN or inf).  The last tests drive, on the
card, shapes and dtypes that the dispatch rules admit or send elsewhere:
each must run.
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import fused_adam
from paddle_tpu_torch.ops.cuda import fused_ce
from paddle_tpu_torch.ops.cuda import ring_quant

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


# the bf16 kernel's edges: sequences ending inside a 128 tile (1000) and 64
# rows into one (1088), sq > sk (rows with no key), D = 128
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (256, 256, 64, True), (200, 200, 128, True), (128, 384, 64, True),
    (300, 300, 64, False), (256, 128, 64, True), (1000, 1000, 64, True),
    (1088, 1088, 128, True), (1088, 1088, 64, False), (1088, 1000, 64, True),
    (320, 128, 128, True), (1000, 1000, 128, False)])
def test_flash_kernel_matches_plain(gen, dtype, sq, sk, d, causal):
    qt = _rand(gen, (6, sq, d), dtype)
    kt, vt = _rand(gen, (6, sk, d), dtype), _rand(gen, (6, sk, d), dtype)
    scale = 1.0 / math.sqrt(d)
    before = fa.launches
    out, lse = fa._launch(qt, kt, vt, scale, causal)
    again = fa._launch(qt, kt, vt, scale, causal)
    out_p, lse_p = fa.flash_attention_reference(qt, kt, vt, scale, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    bf16 = dtype == torch.bfloat16
    _close(out, out_p, 2e-2 if bf16 else 1e-4)
    _close(lse, lse_p, 1e-3 if bf16 else 1e-4)
    if sq > sk and causal:               # rows with no key: exact zeros
        assert float(out[:, :sq - sk].abs().max()) == 0.0
        assert bool(torch.isneginf(lse[:, :sq - sk]).all())


def test_flash_kernel_rejects_what_it_does_not_take(gen):
    # the rule sends head dims other than 64 and 128, and f16, to the dense
    # path; a caller that bypasses it meets the wrapper's raise
    q = _rand(gen, (2, 128, 2, 96), torch.bfloat16)
    assert not fa.supported(q.shape, q.shape, causal=True, dtype=q.dtype)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, causal=True)
    q = _rand(gen, (2, 128, 2, 64), torch.float16)
    assert not fa.supported(q.shape, q.shape, causal=True, dtype=q.dtype)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q, causal=True)


TOL_GRAD_BF16 = 0.1
TOL_CE_GRAD_BF16 = 0.03


def _close_grad(a, b, tol):
    a, b = a.float().cpu(), b.float().cpu()
    assert bool(torch.isfinite(a).all())
    rms = b.pow(2).mean().sqrt()
    assert float(((a - b).abs() / (b.abs() + rms)).max()) <= tol


# the bf16 kernels' edges: sequences ending inside a 128 tile (1000) and 64
# rows into one (1088), at D = 64 and 128, sq > sk (rows with no key), sq <
# sk; every case also holds two calls bitwise equal
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (256, 256, 64, True), (200, 200, 128, True), (128, 384, 64, True),
    (300, 300, 64, False), (256, 256, 128, False), (256, 128, 64, True),
    (1000, 1000, 64, True), (1088, 1088, 64, True), (1088, 1000, 64, True),
    (1000, 1000, 128, True), (1088, 1088, 128, False), (320, 128, 128, True)])
def test_flash_bwd_kernels_match_plain(gen, dtype, sq, sk, d, causal):
    qt = _rand(gen, (6, sq, d), dtype)
    kt, vt = _rand(gen, (6, sk, d), dtype), _rand(gen, (6, sk, d), dtype)
    dot = _rand(gen, (6, sq, d), dtype)
    scale = 1.0 / math.sqrt(d)
    ot, lse = fa.flash_attention_reference(qt, kt, vt, scale, causal)
    before = (fa.launches_dq, fa.launches_dkv)
    got = fa._launch_bwd(qt, kt, vt, ot, lse, dot, scale, causal)
    again = fa._launch_bwd(qt, kt, vt, ot, lse, dot, scale, causal)
    want = fa.flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot, scale,
                                            causal)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 2,
                                                 before[1] + 2)
    for a, b in zip(got[:3], again[:3]):
        assert torch.equal(a, b)
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


TOL_DBIAS_BF16 = 0.05


def _masked_case(gen, dtype, bias_shape, bias_dtype, segs, b=2, h=3, s=256,
                 d=64, sk=None):
    """Folded q, k, v, do and the mask of one masked call (sk keys, s by
    default)."""
    sk = s if sk is None else sk
    qt, dot = (_rand(gen, (b * h, s, d), dtype) for _ in range(2))
    kt, vt = (_rand(gen, (b * h, sk, d), dtype) for _ in range(2))
    bias = None if bias_shape is None else _rand(gen, bias_shape, bias_dtype)
    q_seg = kv_seg = None
    if segs:
        q_seg = (torch.arange(s, device="cuda") // 96).int().expand(
            b, s).contiguous()
        kv_seg = (torch.arange(sk, device="cuda") // 64).int().expand(
            b, sk).contiguous()
    return qt, kt, vt, dot, fa.Mask(bias, q_seg, kv_seg, h)


# each bias class, f32 and bf16 biases, segment ids, and both together, at
# (sq, sk, d) = (256, 256, 64); then the bf16 kernel's edges under a mask:
# D = 128, three key tiles crossed by the diagonal, sq > sk (rows with no
# key)
_MASKED = [((1, 1, 1, 256), torch.float32, False, False, 256, 256, 64),
           ((1, 3, 256, 256), torch.bfloat16, False, True, 256, 256, 64),
           ((2, 1, 1, 256), torch.float32, False, True, 256, 256, 64),
           ((2, 3, 256, 256), torch.float32, False, False, 256, 256, 64),
           ((1, 1, 256, 256), torch.bfloat16, False, False, 256, 256, 64),
           ((2, 3, 1, 256), torch.bfloat16, False, True, 256, 256, 64),
           ((1, 3, 1, 256), torch.float32, False, False, 256, 256, 64),
           ((2, 1, 256, 256), torch.bfloat16, False, True, 256, 256, 64),
           (None, None, True, False, 256, 256, 64),
           (None, None, True, True, 256, 256, 64),
           ((1, 3, 256, 256), torch.float32, True, True, 256, 256, 64),
           ((2, 1, 1, 256), torch.float32, False, True, 256, 256, 128),
           ((1, 3, 256, 256), torch.bfloat16, True, False, 256, 256, 128),
           ((2, 1, 1, 384), torch.float32, False, True, 384, 384, 64),
           ((2, 3, 384, 128), torch.bfloat16, False, True, 384, 128, 64),
           ((2, 1, 1, 128), torch.float32, False, True, 256, 128, 128),
           ((2, 1, 1, 512), torch.float32, False, True, 512, 512, 128),
           ((2, 1, 1, 128), torch.float32, False, False, 128, 128, 64),
           ((2, 3, 128, 384), torch.bfloat16, False, True, 128, 384, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_shape,bias_dtype,segs,causal,sq,sk,d",
                         _MASKED)
def test_masked_flash_kernels_match_plain(gen, dtype, bias_shape, bias_dtype,
                                          segs, causal, sq, sk, d):
    qt, kt, vt, dot, mask = _masked_case(gen, dtype, bias_shape, bias_dtype,
                                         segs, s=sq, d=d, sk=sk)
    bf16 = dtype == torch.bfloat16
    before = (fa.launches_masked, fa.launches_dq_masked,
              fa.launches_dkv_masked, fa.launches_dbias)
    out, lse = fa._launch(qt, kt, vt, 0.125, causal, mask)
    again = fa._launch(qt, kt, vt, 0.125, causal, mask)
    out_p, lse_p = fa.flash_attention_reference(qt, kt, vt, 0.125, causal,
                                                mask)
    got = fa._launch_bwd(qt, kt, vt, out_p, lse_p, dot, 0.125, causal, mask,
                         dbias=mask.bias is not None)
    again_bwd = fa._launch_bwd(qt, kt, vt, out_p, lse_p, dot, 0.125, causal,
                               mask, dbias=mask.bias is not None)
    want = fa._bwd_reference(qt, kt, vt, out_p, lse_p, dot, 0.125, causal,
                             mask, dbias=mask.bias is not None)
    torch.cuda.synchronize()
    has_bias = int(mask.bias is not None)
    assert (fa.launches_masked, fa.launches_dq_masked,
            fa.launches_dkv_masked, fa.launches_dbias) == (
        before[0] + 2, before[1] + 2, before[2] + 2, before[3] + 2 * has_bias)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    for a, b in zip(got[:3 + has_bias], again_bwd[:3 + has_bias]):
        assert torch.equal(a, b)
    _close(out, out_p, 2e-2 if bf16 else 1e-4)
    _close(lse, lse_p, 1e-3 if bf16 else 1e-4)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == dtype and g.shape == w.shape
        if bf16:
            _close_grad(g, w, TOL_GRAD_BF16)
        else:
            _close(g, w, 1e-4)
    if has_bias:
        assert got[3].dtype == bias_dtype and got[3].shape == bias_shape
        if bf16:
            _close_grad(got[3], want[3], TOL_DBIAS_BF16)
        else:
            _close(got[3], want[3], 1e-4)


# the bf16 dbias kernel's splits (fa.dbias_plan) whose last run is short:
# 21 batch terms in 11 runs of 2; with one query row, 69 slices in 35 runs
# of 2; at D = 128, 60 slices in 8 runs of 8
@pytest.mark.parametrize("bias_shape,b,h,d,causal", [
    ((1, 3, 256, 256), 21, 3, 64, True),
    ((1, 1, 1, 256), 23, 3, 64, False),
    ((1, 1, 256, 256), 20, 3, 128, True)])
def test_dbias_kernel_across_split_seams(gen, bias_shape, b, h, d, causal):
    qt, kt, vt, dot, mask = _masked_case(gen, torch.bfloat16, bias_shape,
                                         torch.bfloat16, False, b=b, h=h,
                                         d=d)
    n_r, _, per, n_split = fa.dbias_plan(mask, b * h, 256, 256, d)
    assert n_split > 1 and n_r - (n_split - 1) * per < per
    scale = 1.0 / math.sqrt(d)
    ot, lse = fa.flash_attention_reference(qt, kt, vt, scale, causal, mask)
    delta = fa._delta(dot, ot)
    got = fa._launch_dbias(qt, kt, vt, dot, lse, delta, scale, causal, mask)
    again = fa._launch_dbias(qt, kt, vt, dot, lse, delta, scale, causal,
                             mask)
    want = fa.flash_attention_dbias_reference(qt, kt, vt, ot, lse, dot,
                                              scale, causal, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close_grad(got, want, TOL_DBIAS_BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bool_mask_rows_with_no_key_are_exact_zeros(gen, dtype):
    qt, kt, vt, dot, _ = _masked_case(gen, dtype, None, None, False)
    keep = torch.ones(2, 1, 256, 256, dtype=torch.bool, device="cuda")
    keep[0, :, :70] = False
    keep[1, :, 200:] = False
    bias = fa._canon_bias(keep, 2, 3, 256, 256)
    mask = fa.Mask(bias, None, None, 3)
    out, lse = fa._launch(qt, kt, vt, 0.125, False, mask)
    dq, dk, dv, db = fa._launch_bwd(qt, kt, vt, out, lse, dot, 0.125, False,
                                    mask, dbias=True)
    torch.cuda.synchronize()
    for t in (out, dq):
        assert float(t[:3, :70].abs().max()) == 0.0
        assert float(t[3:, 200:].abs().max()) == 0.0
    assert bool(torch.isneginf(lse[:3, :70]).all())
    assert bool(torch.isfinite(dk).all() and torch.isfinite(dv).all())
    assert float(db[0, 0, :70].abs().max()) == 0.0
    out_p, lse_p = fa.flash_attention_reference(qt, kt, vt, 0.125, False,
                                                mask)
    _close(out, out_p, 2e-2 if dtype == torch.bfloat16 else 1e-4)
    _close(lse, lse_p, 1e-3 if dtype == torch.bfloat16 else 1e-4)


def test_masked_kernels_reject_what_they_do_not_take(gen):
    qt, kt, vt, _, mask = _masked_case(gen, torch.bfloat16, (2, 1, 1, 256),
                                       torch.float32, False)
    with pytest.raises(ValueError, match="multiples of 128"):
        fa._launch(qt[:, :192].contiguous(), kt[:, :192].contiguous(),
                   vt[:, :192].contiguous(), 0.125, False,
                   fa.Mask(mask.bias[..., :192].contiguous(), None, None, 3))
    with pytest.raises(ValueError, match="not canonical"):
        fa._launch(qt, kt, vt, 0.125, False,
                   fa.Mask(mask.bias[:1, :1, :1, :128].contiguous(), None,
                           None, 3))
    with pytest.raises(ValueError, match="float32 or bfloat16 bias"):
        fa._launch(qt, kt, vt, 0.125, False,
                   fa.Mask(mask.bias.half(), None, None, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_learned_bias_autograd_on_card_matches_cpu(gen, dtype):
    q, k, v = (_rand(gen, (2, 256, 4, 64), dtype).requires_grad_()
               for _ in range(3))
    bias = _rand(gen, (1, 4, 256, 256), dtype).requires_grad_()
    w = _rand(gen, (2, 256, 4, 64), dtype)
    before = fa.launches_dbias
    (fa.flash_attention(q, k, v, bias=bias) * w).sum().backward()
    torch.cuda.synchronize()
    assert fa.launches_dbias == before + 1
    qc, kc, vc, bc = (t.detach().cpu().requires_grad_()
                      for t in (q, k, v, bias))
    (fa.flash_attention(qc, kc, vc, bias=bc) * w.cpu()).sum().backward()
    for g, c in zip((q.grad, k.grad, v.grad), (qc.grad, kc.grad, vc.grad)):
        if dtype == torch.bfloat16:
            _close_grad(g, c, TOL_GRAD_BF16)
        else:
            _close(g, c, 1e-4)
    if dtype == torch.bfloat16:
        _close_grad(bias.grad, bc.grad, TOL_DBIAS_BF16)
    else:
        _close(bias.grad, bc.grad, 1e-4)


def test_padding_mask_never_launches_dbias(gen):
    q, k, v = (_rand(gen, (2, 256, 4, 64), torch.bfloat16).requires_grad_()
               for _ in range(3))
    keep = torch.ones(2, 1, 1, 256, dtype=torch.bool, device="cuda")
    keep[1, ..., 150:] = False
    before = (fa.launches_dq_masked, fa.launches_dbias)
    fa.flash_attention(q, k, v, bias=keep).sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches_dq_masked, fa.launches_dbias) == (before[0] + 1,
                                                          before[1])


# V ragged against the bf16 kernel's 256-row vocabulary tile in every case
# (GPT-2's 50,304 is 196.5 tiles); every case holds two calls bitwise equal
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,v", [(256, 256, 1000), (300, 128, 777),
                                   (1, 128, 64), (300, 1024, 50304)])
def test_ce_kernel_matches_plain(gen, dtype, n, h, v):
    hs = _rand(gen, (n, h), dtype)
    w = _rand(gen, (v, h), dtype, 0.05)
    before = fused_ce.launches
    logz = fused_ce._launch(hs, w)
    again = fused_ce._launch(hs, w)
    torch.cuda.synchronize()
    assert fused_ce.launches == before + 2
    assert torch.equal(logz, again)
    _close(logz, fused_ce.ce_logz_reference(hs, w),
           1e-3 if dtype == torch.bfloat16 else 1e-4)


def test_ce_kernel_rejects_what_it_does_not_take(gen):
    hs = _rand(gen, (64, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        fused_ce.ce_logz(hs, _rand(gen, (100, 256), torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fused_ce.ce_logz(hs.T, hs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,v", [(256, 256, 1000), (300, 128, 777),
                                   (64, 1024, 512), (1, 128, 64)])
def test_ce_bwd_kernels_match_plain(gen, dtype, n, h, v):
    hs = _rand(gen, (n, h), dtype)
    w = _rand(gen, (v, h), dtype, 0.05)
    logz = fused_ce.ce_logz_reference(hs, w)
    g = torch.randn(n, generator=gen, device="cuda")
    g[1::3] = 0.0                        # masked rows contribute nothing
    before = (fused_ce.launches_dh, fused_ce.launches_dw)
    got = fused_ce._launch_bwd(hs, w, logz, g)
    want = fused_ce.ce_bwd_reference(hs, w, logz, g)
    torch.cuda.synchronize()
    assert (fused_ce.launches_dh, fused_ce.launches_dw) == (before[0] + 1,
                                                            before[1] + 1)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.bfloat16:
            _close_grad(a, b, TOL_CE_GRAD_BF16)
        else:
            _close(a, b, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_autograd_on_card_matches_cpu(gen, dtype):
    hs = _rand(gen, (300, 256), dtype).requires_grad_()
    w = _rand(gen, (1000, 256), dtype, 0.05).requires_grad_()
    lab = torch.randint(0, 1000, (300,), generator=gen, device="cuda")
    lab[::7] = -1
    wt = (lab >= 0).float()
    before = (fused_ce.launches, fused_ce.launches_dh, fused_ce.launches_dw)
    (fused_ce.fused_linear_cross_entropy(hs, w, lab) * wt).sum().backward()
    torch.cuda.synchronize()
    assert (fused_ce.launches, fused_ce.launches_dh,
            fused_ce.launches_dw) == tuple(c + 1 for c in before)
    hc, wc = (t.detach().cpu().requires_grad_() for t in (hs, w))
    (fused_ce.fused_linear_cross_entropy(hc, wc, lab.cpu())
     * wt.cpu()).sum().backward()
    for a, b in ((hs.grad, hc.grad), (w.grad, wc.grad)):
        if dtype == torch.bfloat16:
            _close_grad(a, b, TOL_CE_GRAD_BF16)
        else:
            _close(a, b, 1e-4)


def test_ce_bwd_kernels_reject_what_they_do_not_take(gen):
    hs = _rand(gen, (64, 2048), torch.bfloat16)
    w = _rand(gen, (100, 2048), torch.bfloat16)
    logz = torch.zeros(64, device="cuda")
    # any width that is a multiple of 128 runs, under grad too
    assert fused_ce.supported(64, 2048, torch.bfloat16)
    with pytest.raises(ValueError, match="logz"):
        fused_ce._launch_bwd(hs, w, logz[:32], logz)
    with pytest.raises(ValueError, match="one dtype"):
        fused_ce._launch_bwd(hs, w.float(), logz, logz)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_ce._launch_bwd(hs[:, :96].contiguous(),
                             w[:, :96].contiguous(), logz, logz)


# The bf16 backward over vocabulary chunks (P's scratch held to `budget`
# bytes; None: the default): N = 300, 8000 and 8192; V = 1000, 50304, a V
# that is an exact multiple of the chunk and one that is a multiple plus
# 1; H = 256, 1024 and 1280.  Two calls are bitwise equal.
_TAIL = 2 * 300 * 256                      # 256-row chunks at 300 tokens


@pytest.mark.parametrize("n,h,v,budget", [
    (300, 256, 1000, None), (300, 256, 1000, _TAIL), (300, 1280, 1000, _TAIL),
    (300, 256, 1024, _TAIL), (300, 1024, 1025, _TAIL),
    (8000, 1024, 50304, None), (8192, 1024, 50304, None),
    (8192, 1280, 50304, None), (8192, 256, 7296 * 3, None),
    (8192, 1024, 3 * 512 + 1, 2 * 8192 * 512)])
def test_ce_bwd_chunks_match_plain_and_repeat(gen, n, h, v, budget):
    hs = _rand(gen, (n, h), torch.bfloat16)
    w = _rand(gen, (v, h), torch.bfloat16, 0.02)
    logz = fused_ce.ce_logz_reference(hs, w)
    g = torch.randn(n, generator=gen, device="cuda")
    g[::7] = 0.0
    args = (hs, w, logz, g) + (() if budget is None else (budget,))
    vc = fused_ce.chunk_width(n, v, *args[4:])
    if v in (1024, 7296 * 3):
        assert v % vc == 0                # an exact multiple of the chunk
    if v in (1025, 3 * 512 + 1):
        assert v % vc == 1                # a last chunk of one row
    before = (fused_ce.launches_dh, fused_ce.launches_dw)
    got = fused_ce._launch_bwd(*args)
    again = fused_ce._launch_bwd(*args)
    want = fused_ce.ce_bwd_reference(hs, w, logz, g)
    torch.cuda.synchronize()
    assert (fused_ce.launches_dh, fused_ce.launches_dw) == (before[0] + 2,
                                                            before[1] + 2)
    for a, b, c in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and a.shape == c.shape
        assert torch.equal(a, b)
        _close_grad(a, c, TOL_CE_GRAD_BF16)


def _adam_inputs(gen, sizes):
    def t(scale):
        return [torch.randn(s, generator=gen, device="cuda") * scale
                for s in sizes]
    return t(0.02), t(1e-2), t(1e-3), [x.abs() for x in t(1e-3)]


# exact chunks, tails, one element, and more tensors than one launch takes
@pytest.mark.parametrize("sizes", [[4096, 128, 1], [100003, 2048 * 3 + 5],
                                   [7] * 40])
def test_adam_kernel_matches_plain(gen, sizes):
    p, g, m, v = _adam_inputs(gen, sizes)
    lr_t = torch.rand(len(sizes), generator=gen, device="cuda") * 1e-3
    wd_lr = torch.tensor(1e-5, device="cuda")
    before = fused_adam.launches
    got = fused_adam._launch(p, g, m, v, lr_t, wd_lr, 0.9, 0.999, 1e-8)
    want = fused_adam.fused_adam_reference(p, g, m, v, lr_t, wd_lr, 0.9,
                                           0.999, 1e-8)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + -(-len(sizes) // 32)
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()) <= 1e-6
    for a, b, p0 in zip(got[0], want[0], p):
        move = (b - p0).abs().max()
        assert float((a - b).abs().max()) <= 1e-3 * float(move)


def test_adam_kernel_writes_into_its_inputs(gen):
    p, g, m, v = _adam_inputs(gen, [3000, 64])
    args = (torch.full((2,), 1e-3, device="cuda"),
            torch.tensor(1e-5, device="cuda"), 0.9, 0.999, 1e-8)
    fresh = fused_adam._launch(p, g, m, v, *args)
    ptrs = [t.data_ptr() for t in p + m + v]
    got = fused_adam._launch(p, g, m, v, *args, out=(p, m, v))
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in got[0] + got[1] + got[2]] == ptrs
    for a, b in zip(got[0] + got[1] + got[2],
                    fresh[0] + fresh[1] + fresh[2]):
        assert torch.equal(a, b)


def test_adam_kernel_rejects_what_it_does_not_take(gen):
    p, g, m, v = _adam_inputs(gen, [64])
    args = (torch.ones(1, device="cuda"), torch.zeros((), device="cuda"),
            0.9, 0.999, 1e-8)
    with pytest.raises(ValueError, match="float32"):
        fused_adam._launch([p[0].bfloat16()], g, m, v, *args)
    with pytest.raises(ValueError, match="aligned"):
        fused_adam._launch([p[0][1:]], [g[0][1:]], [m[0][1:]], [v[0][1:]],
                           *args)


def _adam_bf16_inputs(gen, sizes, offset=0):
    """bf16 (p, g, m, v), each tensor a view ``offset`` elements into its
    own buffer (offset 0: 16-byte aligned)."""
    def t(scale, off=offset):
        return [(torch.randn(s + off, generator=gen, device="cuda")
                 * scale).bfloat16()[off:] for s in sizes]
    return t(0.02), t(1e-2), t(1e-3), [x.abs() for x in t(1e-3)]


def _adam_bf16_check(p, g, m, v, lr_t):
    wd_lr = torch.tensor(1e-5, device="cuda")
    before = fused_adam.launches_bf16
    got = fused_adam._launch(p, g, m, v, lr_t, wd_lr, 0.9, 0.999, 1e-8)
    again = fused_adam._launch(p, g, m, v, lr_t, wd_lr, 0.9, 0.999, 1e-8)
    want = fused_adam.fused_adam_reference(p, g, m, v, lr_t, wd_lr, 0.9,
                                           0.999, 1e-8)
    torch.cuda.synchronize()
    assert fused_adam.launches_bf16 == before + 2 * -(-len(p) // 32)
    for a, b, c in zip(got[0] + got[1] + got[2], want[0] + want[1] + want[2],
                       again[0] + again[1] + again[2]):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b) and torch.equal(a, c)


# the bf16 instantiation: bitwise its plain version (the same f32 operations
# in the same order, rounded to nearest even on the store) at whole chunks,
# tails that are no multiple of 8, and more tensors than one launch takes
@pytest.mark.parametrize("sizes", [
    [4096, 128, 8, 1], [100003, 2048 * 3 + 5, 13],
    [100003, 2048 * 3 + 5, 13, 1], [4099, 77], [7] * 40])
def test_adam_bf16_kernel_is_bitwise_plain(gen, sizes):
    p, g, m, v = _adam_bf16_inputs(gen, sizes)
    lr_t = torch.rand(len(sizes), generator=gen, device="cuda") * 1e-3
    _adam_bf16_check(p, g, m, v, lr_t)


def test_adam_bf16_kernel_refuses_a_start_off_16_bytes(gen):
    """p starting 2 bytes off a boundary, m 6 bytes off, g and v on it:
    refused, as the f32 instantiation refuses it (the optimizers' tensors
    are allocations of their own, each on a boundary)."""
    p, _, _, _ = _adam_bf16_inputs(gen, [5000], 1)
    _, g, _, v = _adam_bf16_inputs(gen, [5000], 0)
    _, _, m, _ = _adam_bf16_inputs(gen, [5000], 3)
    before = fused_adam.launches_bf16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_adam._launch(p, g, m, v, torch.full((1,), 1e-3, device="cuda"),
                           torch.tensor(1e-5, device="cuda"), 0.9, 0.999,
                           1e-8)
    assert fused_adam.launches_bf16 == before


def test_adam_bf16_kernel_writes_into_its_inputs(gen):
    p, g, m, v = _adam_bf16_inputs(gen, [3000, 64])
    args = (torch.full((2,), 1e-3, device="cuda"),
            torch.tensor(1e-5, device="cuda"), 0.9, 0.999, 1e-8)
    fresh = fused_adam._launch(p, g, m, v, *args)
    got = fused_adam._launch(p, g, m, v, *args, out=(p, m, v))
    torch.cuda.synchronize()
    for a, b in zip(got[0] + got[1] + got[2],
                    fresh[0] + fresh[1] + fresh[2]):
        assert torch.equal(a, b)
    assert got[0][0].data_ptr() == p[0].data_ptr()


def test_adam_rejects_mixed_dtypes_on_the_card(gen):
    p, g, m, v = _adam_bf16_inputs(gen, [64])
    args = (torch.ones(1, device="cuda"), torch.zeros((), device="cuda"),
            0.9, 0.999, 1e-8)
    with pytest.raises(ValueError, match="all-f32 or all-bf16"):
        fused_adam._launch(p, g, [m[0].float()], v, *args)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_adam._launch([x.half() for x in p], [x.half() for x in g],
                           [x.half() for x in m], [x.half() for x in v],
                           *args)


# ---------------------------------------------------------------------------
# the row quantizer (#9)
# ---------------------------------------------------------------------------

def _quant_rows(gen, r, d):
    x = torch.randn(r, d, generator=gen, device="cuda") * 3
    x[0] = 0.0                                       # scale 1, q 0
    if d >= 4:
        x[-1, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])   # ties
    return x


@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("r,d", [(1, 1), (7, 8), (300, 13), (7, 127),
                                 (300, 128), (7, 255), (1000, 256),
                                 (300, 384), (7, 1024), (100000, 256),
                                 (5, 2000)])
def test_ring_quant_kernel_bitwise_plain(gen, wire, r, d):
    x = _quant_rows(gen, r, d)
    before = ring_quant.launches
    q, s = ring_quant._launch(x, wire)
    qp, sp = ring_quant.ring_quant_rows_reference(x, wire)
    torch.cuda.synchronize()
    assert ring_quant.launches == before + 1
    assert q.dtype == qp.dtype and q.shape == qp.shape
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_ring_quant_nan_and_inf_rows(gen, wire):
    x = _quant_rows(gen, 6, 256)
    x[1, 7] = float("nan")
    x[2, 9] = float("inf")
    x[3, 0] = -float("inf")
    q, s = ring_quant._launch(x, wire)
    qp, sp = ring_quant.ring_quant_rows_reference(x, wire)
    assert torch.equal(s, sp) and float(s[1]) == 1.0
    fin = [0, 4, 5]
    assert torch.equal(q[fin], qp[fin])


def test_ring_quant_rejects_what_it_does_not_take(gen):
    x = _quant_rows(gen, 4, 8)
    with pytest.raises(ValueError, match="cast wire"):
        ring_quant.ring_quant_rows(x, "bf16")
    with pytest.raises(ValueError, match="float32"):
        ring_quant._launch(x.to(torch.bfloat16), "int8")
    q, s = ring_quant.ring_quant_rows(x[:0], "int4")      # no rows
    assert q.shape == (0, 4) and s.shape == (0,)


# ---------------------------------------------------------------------------
# what the dispatch rules admit runs on the card
# ---------------------------------------------------------------------------

def test_head_dim_256_attention_runs(gen):
    import paddle_tpu_torch.nn as tnn
    torch.manual_seed(0)
    mha = tnn.MultiHeadAttention(512, 2).cuda()
    x = torch.randn(2, 128, 512, device="cuda", requires_grad=True)
    before = (fa.launches, fa.launches_masked)
    out = mha(x, x, x)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_masked) == before     # the dense path
    assert bool(torch.isfinite(out).all()) and x.grad is not None


def test_more_than_65535_folded_slices(gen):
    # B*H = 70,000: the slices spill from grid y into z
    q, k, v = (_rand(gen, (70000, 128, 64), torch.bfloat16)
               for _ in range(3))
    scale = 0.125
    assert fa.supported((70000, 128, 1, 64), (70000, 128, 1, 64),
                        causal=True, dtype=torch.bfloat16)
    out, lse = fa._launch(q, k, v, scale, True)
    do = _rand(gen, (70000, 128, 64), torch.bfloat16)
    delta = fa._delta(do, out)
    dq = fa._launch_dq(q, k, v, do, lse, delta, scale, True)
    dk, dv = fa._launch_dkv(q, k, v, do, lse, delta, scale, True)
    for i in (0, 65534, 65535, 69999):           # both sides of the seam
        sl = slice(i, i + 1)
        o_p, l_p = fa.flash_attention_reference(q[sl], k[sl], v[sl], scale,
                                                True)
        _close(out[sl], o_p, 2e-2)
        _close(lse[sl], l_p, 1e-3)
        want = fa.flash_attention_bwd_reference(q[sl], k[sl], v[sl],
                                                out[sl], lse[sl], do[sl],
                                                scale, True)
        for a, b in zip((dq[sl], dk[sl], dv[sl]), want):
            _close_grad(a, b, TOL_GRAD_BF16)


@pytest.mark.parametrize("kind", ["learned", "padding"])
def test_masked_calls_past_65535_folded_slices(gen, kind):
    # B*H = 70,000 with a mask: the launches run in chunks of whole batch
    # entries, each with its tensors and mask offset; the slices across the
    # seam (65,534 = 4,681 x 14) are held to the plain versions
    b, h, s, d = 5000, 14, 128, 64
    q, k, v, do = (_rand(gen, (b, s, h, d), torch.bfloat16)
                   for _ in range(4))
    segs = None
    if kind == "learned":
        bias = _rand(gen, (b, h, s, s), torch.bfloat16).requires_grad_()
    else:
        bias = torch.zeros(b, 1, 1, s, device="cuda")
        bias[:, :, :, 100:] = -1e30
        segs = (torch.arange(s, device="cuda") // 64).repeat(b, 1)
    assert fa.supported(q.shape, k.shape, False, bias_shape=bias.shape,
                        segments=segs is not None, dtype=q.dtype)
    q.requires_grad_()
    out = fa.flash_attention(q, k, v, scale=0.125, bias=bias,
                             q_segment_ids=segs, kv_segment_ids=segs)
    out.backward(do)
    torch.cuda.synchronize()
    lo, hi = 4680, 4683                          # batch entries at the seam
    sl = slice(lo, hi)
    mask = fa.Mask(fa._canon_bias(bias.detach()[sl], hi - lo, h, s, s),
                   None if segs is None else segs[sl].int().contiguous(),
                   None if segs is None else segs[sl].int().contiguous(), h)
    qt, kt, vt, dot = (fa._fold(t.detach()[sl]) for t in (q, k, v, do))
    o_p, l_p = fa.flash_attention_reference(qt, kt, vt, 0.125, False, mask)
    _close(fa._fold(out.detach()[sl]), o_p, 2e-2)
    dq_p = fa.flash_attention_bwd_reference(qt, kt, vt, o_p, l_p, dot, 0.125,
                                            False, mask)[0]
    _close_grad(fa._fold(q.grad[sl]), dq_p, TOL_GRAD_BF16)
    if kind == "learned":
        db_p = fa.flash_attention_dbias_reference(qt, kt, vt, o_p, l_p, dot,
                                                  0.125, False, mask)
        _close_grad(bias.grad[sl], db_p, TOL_DBIAS_BF16)


def test_fused_ce_head_1280_under_grad_runs(gen):
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import GPT, gpt_loss, gpt_tiny
    cfg = gpt_tiny(num_layers=1, hidden_size=1280, num_heads=20,
                   max_seq_len=128)
    m = GPT(cfg, device="cuda").to(torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda")
    set_flags({"gpt_fused_ce": True})
    try:
        before = (fused_ce.launches, fused_ce.launches_dh,
                  fused_ce.launches_dw)
        loss = gpt_loss(m, ids, ids)
        loss.backward()
        torch.cuda.synchronize()
        # the fused head under grad: one forward, one dh and one dW
        assert (fused_ce.launches, fused_ce.launches_dh,
                fused_ce.launches_dw) == tuple(c + 1 for c in before)
    finally:
        set_flags({"gpt_fused_ce": False})
    assert math.isfinite(float(loss.detach())) and m.wte.grad is not None
    # the kernels at this width against the plain version
    hs = _rand(gen, (256, 1280), torch.bfloat16)
    w = _rand(gen, (cfg.vocab_size, 1280), torch.bfloat16, 0.02)
    logz = fused_ce.ce_logz_reference(hs, w)
    g = torch.randn(256, generator=gen, device="cuda")
    got = fused_ce._launch_bwd(hs, w, logz, g)
    for a, b in zip(got, fused_ce.ce_bwd_reference(hs, w, logz, g)):
        _close_grad(a, b, TOL_CE_GRAD_BF16)


def test_o2_float16_train_step_runs(gen):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, gpt_loss, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW
    m = GPT(gpt_tiny(num_layers=2, hidden_size=128, num_heads=2,
                     max_seq_len=128), device="cuda")
    step = TrainStep(m, gpt_loss, AdamW(learning_rate=1e-3),
                     amp_level="O2", amp_dtype="float16")
    ids = torch.randint(0, m.config.vocab_size, (4, 128), device="cuda")
    cpu = GPT(m.config, device="cpu")
    want = float(TrainStep(cpu, gpt_loss, AdamW(learning_rate=1e-3),
                           amp_level="O2", amp_dtype="float16")(
        ids.cpu(), ids.cpu()))
    before = fa.launches
    losses = [float(step(ids, ids)) for _ in range(2)]
    assert fa.launches == before                  # f16: the dense path
    # the first loss agrees with the CPU's; neither package scales the loss
    # and both read NaN after the first update (test_torch_train.py
    # test_o2_float16_matches_reference)
    assert math.isfinite(losses[0]) and abs(losses[0] - want) < 1e-2


def _tiny_gpt_on_card():
    from paddle_tpu_torch.models import GPT, gpt_tiny
    return GPT(gpt_tiny(num_layers=2, hidden_size=128, num_heads=2,
                        max_seq_len=128, remat=False), device="cuda")


def test_custom_ops_launch_inside_a_captured_graph(gen):
    """#1-#3 and #5-#7 as custom ops: a to_static capture of gpt_loss
    launches them from its graph, forward and backward; its loss equals
    the eager call's, its gradients within 1e-6 (the embedding's backward
    sums by atomics, in no fixed order)."""
    from paddle_tpu_torch import jit, nn
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import gpt_loss

    class Loss(nn.Layer):
        def __init__(self, gpt):
            super().__init__()
            self.gpt = gpt

        def forward(self, ids):
            return gpt_loss(self.gpt, ids, ids)

    gpt = _tiny_gpt_on_card()
    ids = torch.randint(0, 256, (2, 128), generator=gen, device="cuda")
    set_flags({"gpt_fused_ce": True})
    try:
        eager = gpt_loss(gpt, ids, ids)
        eager.backward()
        want = {n: p.grad.clone() for n, p in gpt.named_parameters()}
        gpt.clear_gradients()
        net = jit.to_static(Loss(gpt))
        before = (fa.launches, fa.launches_dq, fa.launches_dkv,
                  fused_ce.launches, fused_ce.launches_dh,
                  fused_ce.launches_dw)
        loss = net(ids)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        set_flags({"gpt_fused_ce": False})
    after = (fa.launches, fa.launches_dq, fa.launches_dkv,
             fused_ce.launches, fused_ce.launches_dh, fused_ce.launches_dw)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2, 1, 1, 1)
    assert torch.equal(loss.detach(), eager.detach())
    for n, p in gpt.named_parameters():
        torch.testing.assert_close(p.grad, want[n], rtol=0, atol=1e-6,
                                   msg=n)


def test_loaded_artifact_launches_on_card(gen, tmp_path):
    """jit.save with a dynamic batch, jit.load on the card: the loaded
    graph launches #1 once a layer and equals the eager forward at two
    batch sizes."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec
    gpt = _tiny_gpt_on_card()
    prefix = str(tmp_path / "gpt")
    jit.save(gpt, prefix, input_spec=[InputSpec([None, 128], "int64")])
    loaded = jit.load(prefix, device="cuda")
    for b in (3, 8):
        ids = torch.randint(0, 256, (b, 128), generator=gen, device="cuda")
        before = fa.launches
        out = loaded(ids)
        torch.cuda.synchronize()
        assert fa.launches - before == 2
        assert torch.equal(out, gpt(ids).detach())
