"""Port fused linear + cross-entropy (paddle_tpu_torch.ops.cuda.fused_ce)
against the reference Pallas kernels run in interpret mode on the CPU:
the loss, its gradients (the custom_vjp with its gold-label terms) and the
plain backward against ``_ce_bwd_kernels``.

The same numpy inputs go through both; on the CPU the port's wrapper runs
its plain PyTorch versions.  Tolerance: 1e-5 absolute in f32.
"""
import numpy as np
import pytest
import torch

import jax
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


def _jax_grads(hs, w, lab, wt):
    def loss(h_, w_):
        return jnp.sum(jce.fused_linear_cross_entropy(h_, w_, jnp.asarray(lab))
                       * jnp.asarray(wt))
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(hs), jnp.asarray(w))


# N and V off the 128 grid; labels drawn from few ids repeat, so the gold
# scatter into dW accumulates; -1 sentinels carry weight 0 from the caller
@pytest.mark.parametrize("n,h,v,n_ids", [(300, 256, 1000, 1000),
                                         (200, 128, 777, 5),
                                         (128, 128, 300, 300)])
def test_gradients_match_reference_vjp(n, h, v, n_ids):
    hs, w, lab = _inputs(n, h, v, seed=3)
    lab = np.where(lab >= 0, lab % n_ids, -1).astype(np.int32)
    wt = (np.random.default_rng(4).uniform(0.5, 1.5, n)
          * (lab >= 0)).astype(np.float32)
    want_dh, want_dw = _jax_grads(hs, w, lab, wt)
    h_t = torch.from_numpy(hs).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    loss = tce.fused_linear_cross_entropy(h_t, w_t, torch.from_numpy(lab))
    (loss * torch.from_numpy(wt)).sum().backward()
    np.testing.assert_allclose(h_t.grad.numpy(), np.asarray(want_dh),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(want_dw),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,h,v", [(256, 128, 1000), (300, 256, 640)])
def test_plain_backward_matches_interpret_kernels(n, h, v):
    # ce_bwd_reference is the counterpart of _ce_bwd_kernels: no gold terms
    hs, w, _ = _inputs(n, h, v, seed=5)
    g = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    g[::5] = 0.0                                  # masked rows
    logz = np.array(jce._ce_logz(jce._pad_n(jnp.asarray(hs)),
                                   jce._pad_w(jnp.asarray(w)), v))[:n, 0]
    dh, dw = jce._ce_bwd_kernels(
        jce._pad_n(jnp.asarray(hs)), jce._pad_w(jnp.asarray(w)),
        jce._pad_n(jnp.asarray(logz).reshape(n, 1)),
        jce._pad_n(jnp.asarray(g).reshape(n, 1)), v)
    got_dh, got_dw = tce.ce_bwd_reference(
        torch.from_numpy(hs), torch.from_numpy(w), torch.from_numpy(logz),
        torch.from_numpy(g))
    np.testing.assert_allclose(got_dh.numpy(), np.asarray(dh)[:n], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(dw)[:v], atol=ATOL,
                               rtol=0)


def test_scoring_call_records_nothing():
    hs, w, lab = _inputs(128, 128, 300)
    h_t = torch.from_numpy(hs).requires_grad_()
    with torch.no_grad():
        out = tce.fused_linear_cross_entropy(h_t, torch.from_numpy(w),
                                             torch.from_numpy(lab))
    assert not out.requires_grad and out.grad_fn is None


def test_empty_batch_gradient_is_zero():
    h_t = torch.zeros(0, 128, requires_grad=True)
    w_t = torch.randn(10, 128, requires_grad=True)
    tce.fused_linear_cross_entropy(
        h_t, w_t, torch.zeros(0, dtype=torch.long)).sum().backward()
    assert h_t.grad.shape == (0, 128)
    assert w_t.grad.shape == (10, 128) and not w_t.grad.any()


def test_backward_counts_no_launch_on_cpu():
    hs, w, lab = _inputs(128, 128, 300)
    h_t = torch.from_numpy(hs).requires_grad_()
    before = (tce.launches, tce.launches_dh, tce.launches_dw)
    tce.fused_linear_cross_entropy(h_t, torch.from_numpy(w),
                                   torch.from_numpy(lab)).sum().backward()
    assert (tce.launches, tce.launches_dh, tce.launches_dw) == before


def test_supported_follows_reference_rule():
    jce._INTERPRET = True
    for n, h in [(0, 128), (300, 256), (8192, 1024), (300, 100)]:
        assert tce.supported(n, h) is jce.supported(n, h)


@pytest.mark.parametrize("h,dtype,want", [
    (1280, torch.bfloat16, True),    # forward and backward: any width
    (2048, torch.bfloat16, True),
    (1280, torch.float32, True),
    (1024, torch.bfloat16, True),
    (1024, torch.float16, False),    # f16: the unfused head
])
def test_supported_admits_only_what_the_kernels_run(h, dtype, want):
    assert tce.supported(8192, h, dtype) is want


def test_gpt_loss_takes_the_unfused_head_where_the_rule_refuses(monkeypatch):
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import GPT, gpt_loss, gpt_tiny
    from paddle_tpu_torch.models import gpt as tgpt
    called = []
    monkeypatch.setattr(tgpt, "_gpt_fused_ce_loss",
                        lambda *a: called.append(1) or torch.zeros(()))
    cfg = gpt_tiny(num_layers=1, hidden_size=128, num_heads=2,
                   max_seq_len=128)
    ids = np.zeros((1, 128), np.int64)
    set_flags({"gpt_fused_ce": True})
    try:
        m = GPT(cfg, device="cpu").to(torch.float16)
        gpt_loss(m, ids, ids)                      # f16: unfused
        assert called == []
        m = GPT(cfg, device="cpu").to(torch.bfloat16)
        gpt_loss(m, ids, ids)                      # bf16 under grad: fused
        assert called == [1]
    finally:
        set_flags({"gpt_fused_ce": False})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [(8192, 50304), (8000, 50304), (300, 1000),
                                 (64, 1000), (300, 64), (10, 5), (1, 256),
                                 (1, 257), (10**6, 50304)])
def test_vocab_split_runs_cover_every_tile_once_in_order(dtype, n, v):
    # split s of the forward's grid walks tiles [s per, (s + 1) per) of the
    # dtype's vocabulary tile, per = ceil(tiles / splits), and writes one
    # (max, sum) pair per token: every row in exactly one non-empty run,
    # in order; in bf16 one run per 256-row tile
    block_v = tce._BLOCKS[dtype][1]
    k = tce._n_split(n, v, dtype)
    n_vt = -(-v // block_v)
    per = -(-n_vt // k)
    runs = [range(s * per * block_v, min(v, (s + 1) * per * block_v))
            for s in range(k)]
    assert [r for run in runs for r in run] == list(range(v))
    assert all(len(run) > 0 for run in runs) and k <= 65535
    if dtype == torch.bfloat16:
        assert per == 1 and k == n_vt


def test_vocab_split_covers_every_tile():
    # the CUDA grid splits the vocabulary into k runs of ceil(tiles / k)
    # tiles; together they must cover every tile
    for dtype, (_, block_v) in tce._BLOCKS.items():
        for n, v in [(8192, 50304), (64, 1000), (300, 64), (10, 5)]:
            k = tce._n_split(n, v, dtype)
            n_vt = -(-v // block_v)
            assert 1 <= k <= n_vt
            assert k * -(-n_vt // k) >= n_vt


@pytest.mark.parametrize("n,v,budget", [
    (8192, 50304, None), (8000, 50304, None), (300, 1000, 2 * 300 * 256),
    (300, 1024, 2 * 300 * 256), (300, 1025, 2 * 300 * 256),
    (1, 64, None), (10**6, 50304, None), (256, 50304, 1)])
def test_chunk_width_covers_every_vocab_row_once(n, v, budget):
    # the C launcher runs chunk i over rows [i vc, min(V, (i + 1) vc))
    vc = tce.chunk_width(n, v, *(() if budget is None else (budget,)))
    cap = tce.P_BUDGET if budget is None else budget
    assert vc % 128 == 0 and (2 * n * vc <= cap or vc == 128)
    seen = np.zeros(v, np.int64)
    for i in range(-(-v // vc)):
        seen[i * vc:min(v, (i + 1) * vc)] += 1
    assert (seen == 1).all()
    assert v - (-(-v // vc) - 1) * vc > 0          # no empty last chunk


def test_chunk_width_of_the_345m_head():
    # 7 even chunks: P's scratch 114 MiB, the last chunk 6528 rows
    assert tce.chunk_width(8192, 50304) == 7296


def test_other_devices_raise():
    h = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tce.ce_logz(h, h)


# The card check's measure of the bf16 dh and dW (chip_smoke.py and
# tests/test_torch_cuda_kernels.py): max |got - want| / (|want| + rms(want))
# per tensor, held to TOL_CE_GRAD_BF16.  chip_smoke.ce_bwd_faults plants the
# faults the chunked kernels can make into the plain backward; each must
# read above the limit on dh or dW, and leaving p unrounded must read well
# below it, at the tail shape in 256-row chunks (as the card check runs it)
# and at the GPT-2 345M head's width in the chunks of the full head (a
# 256-token slice: a dh row depends on its own token only, and fewer rows
# can only lower the largest reading).  chip_smoke.py reads the same faults
# at the full head.
TOL_CE_GRAD_BF16 = 0.03
_FAULT_CASES = {"tails": (300, 256, 1000), "345m_width": (256, 1024, 50304)}
_COMMON = ["P pass skips a tile", "dW pass skips a tile",
           "dh pass skips a tile", "a score tile misses a K-step",
           "a chunk overwrites dh's sum", "a dW chunk lands a tile late"]
_FAULTS = {"tails": _COMMON + ["p unmasked past V", "p unmasked past N"],
           "345m_width": _COMMON}


def _grad_err(a, b):
    a, b = a.float(), b.float()
    rms = b.pow(2).mean().sqrt()
    return float(((a - b).abs() / (b.abs() + rms)).max())


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=list(_FAULT_CASES))
def bf16_ce_case(request):
    n, h, v = _FAULT_CASES[request.param]
    rng = np.random.default_rng(12)
    hs = torch.from_numpy(rng.standard_normal((n, h), dtype=np.float32))
    w = torch.from_numpy(0.02 * rng.standard_normal((v, h), dtype=np.float32))
    hs, w = hs.bfloat16(), w.bfloat16()
    g = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
    g[::7] = 0.0                                  # sentinel rows
    logz = tce.ce_logz_reference(hs, w)
    want = tce.ce_bwd_reference(hs, w, logz, g)
    ctl = tce.ce_bwd_reference(hs.float(), w.float(), logz, g)
    cs = _chip_smoke()
    vc = (tce.chunk_width(n, v, cs.CE_TAIL_BUDGET) if request.param == "tails"
          else tce.chunk_width(8192, v))
    assert -(-v // vc) >= 4
    faults = {name: max(_grad_err(x, want[0]), _grad_err(y, want[1]))
              for name, x, y in cs.ce_bwd_faults(hs, w, logz, g, vc)}
    return request.param, [_grad_err(c.bfloat16(), x)
                           for c, x in zip(ctl, want)], faults


def test_bf16_gradient_measure_flags_faults(bf16_ce_case):
    case, _, faults = bf16_ce_case
    assert sorted(faults) == sorted(_FAULTS[case])
    for name, reading in faults.items():
        assert reading > TOL_CE_GRAD_BF16, (case, name, reading)


def test_bf16_gradient_measure_passes_rounding_control(bf16_ce_case):
    # p left in f32: the size of an honest rounding difference
    _, ctl, _ = bf16_ce_case
    assert max(ctl) < TOL_CE_GRAD_BF16 / 2


# The card check of the bf16 logz kernel (chip_smoke.check_ce): max |got -
# want| held to TOL_LSE on chip_smoke.ce_fwd_inputs, whose logits put each
# fault chip_smoke.ce_fwd_faults plants where it shows; each must read
# above the limit, and logz in float64 from the same bf16 inputs (the size
# of an honest difference of summation order) well below it.  At the tail
# shape and at the 345M head's width and vocabulary (200 tokens: a tail
# token tile).
_LOGZ_FAULTS = ["a tile misses a K-slice", "columns past V unmasked",
                "the merge drops a vocabulary tile",
                "a tail row reads the next row"]


@pytest.mark.parametrize("n,h,v", [(300, 256, 1000), (200, 1024, 50304)])
def test_logz_measure_flags_faults_and_passes_rounding_control(n, h, v):
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(13)
    hs, w = cs.ce_fwd_inputs(g, n, h, v, torch.bfloat16)
    want = tce.ce_logz_reference(hs, w)
    ctl = torch.logsumexp(hs.double() @ w.double().T, -1).float()
    assert float((ctl - want).abs().max()) < cs.TOL_LSE / 10
    faults = cs.ce_fwd_faults(hs, w)
    assert [name for name, _ in faults] == _LOGZ_FAULTS
    for name, bad in faults:
        assert bad.shape == want.shape
        assert float((bad - want).abs().max()) > cs.TOL_LSE, name
