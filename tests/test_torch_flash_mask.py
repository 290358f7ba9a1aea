"""The port's masked flash attention (an additive or bool bias, segment ids)
and its bias gradient against the reference Pallas kernels run in interpret
mode on the CPU.

The same numpy inputs go through both.  On the CPU the port's wrapper runs
its plain PyTorch versions (flash_attention_reference,
flash_attention_bwd_reference, flash_attention_dbias_reference); the CUDA
kernels are held to those on the card by chip_smoke.py and
tests/test_torch_cuda_kernels.py.  Tolerances: 2e-5 absolute on f32
outputs and lse, 1e-4 absolute on f32 gradients and dbias (the two sum in
different orders).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

ATOL = 2e-5
ATOL_GRAD = 1e-4
B, S, H, D = 2, 128, 2, 64
SCALE = 0.125


@pytest.fixture(autouse=True)
def _interpret():
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = False


def _qkv(seed, b=B, s=S, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _ref(q, k, v, w, causal, bias=None, segs=None):
    """(out, lse (B*H, Sq), [dq, dk, dv, dbias]) of the reference kernels:
    the forward, then jax.grad of sum(flash_attention(...) * w)."""
    qs = ks = None
    if segs is not None:
        qs = ks = jnp.asarray(segs)
    jb = None if bias is None else jnp.asarray(bias)

    def loss(q, k, v, b):
        return jnp.sum(jfa.flash_attention(
            q, k, v, causal=causal, scale=SCALE, bias=b, q_segment_ids=qs,
            kv_segment_ids=ks) * w)

    args = [jnp.asarray(a) for a in (q, k, v)] + [jb]
    n = 4 if jb is not None and jb.dtype != jnp.bool_ else 3
    grads = jax.grad(loss, argnums=tuple(range(n)))(*args)
    canon = None
    if jb is not None:
        b, sq, h, _ = q.shape
        canon = jfa._canon_bias_shape(jb.shape, b, h, sq, k.shape[1])
        canon = (jnp.where(jb, 0.0, -jnp.inf) if jb.dtype == jnp.bool_
                 else jb).astype(jnp.float32).reshape(canon)
    qf = None if qs is None else qs.astype(jnp.float32)
    out, lse = jfa._flash_fwd(*args[:3], canon, qf, qf, SCALE, causal)
    return (np.asarray(out), np.asarray(lse)[..., 0],
            [np.asarray(g) for g in grads])


def _port(q, k, v, w, causal, bias=None, segs=None):
    """The same through the port's custom ops on the CPU."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    bt = None
    if bias is not None:
        bt = torch.from_numpy(bias)
        if bt.is_floating_point():
            bt.requires_grad_()
    st = None if segs is None else torch.from_numpy(segs)
    out, lse = tfa.flash_attention_fwd(qt, kt, vt, causal=causal,
                                       scale=SCALE, bias=bt,
                                       q_segment_ids=st, kv_segment_ids=st)
    (out * torch.from_numpy(w)).sum().backward()
    grads = [t.grad.numpy() for t in (qt, kt, vt)]
    if bt is not None and bt.requires_grad:
        grads.append(bt.grad.numpy())
    return out.detach().numpy(), lse.numpy(), grads


def _compare(got, want):
    out, lse, grads = got
    out_j, lse_j, grads_j = want
    np.testing.assert_allclose(out, out_j, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse[fin], lse_j[fin], atol=ATOL, rtol=0)
    assert len(grads) == len(grads_j)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, grads_j):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=ATOL_GRAD, rtol=0,
                                   err_msg=name)


# the four broadcast classes of the bias's (batch, head) extent, each with
# one query row and with a full query dim
_CLASSES = [(bb, hb, sqb) for bb, hb in ((1, 1), (1, H), (B, 1), (B, H))
            for sqb in (1, S)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bb,hb,sqb", _CLASSES)
def test_bias_class_matches_interpret_kernels(bb, hb, sqb, causal):
    q, k, v = _qkv(1)
    rng = np.random.default_rng(2)
    bias = rng.standard_normal((bb, hb, sqb, S)).astype(np.float32)
    w = rng.standard_normal(q.shape).astype(np.float32)
    _compare(_port(q, k, v, w, causal, bias=bias),
             _ref(q, k, v, w, causal, bias=bias))


def test_short_bias_shape_is_canonicalised():
    # a (Sk,) bias broadcasts over batch, heads and queries: class (1, 1)
    # with one query row, and its gradient keeps the caller's shape
    q, k, v = _qkv(3)
    rng = np.random.default_rng(4)
    bias = rng.standard_normal((S,)).astype(np.float32)
    w = rng.standard_normal(q.shape).astype(np.float32)
    got = _port(q, k, v, w, False, bias=bias)
    assert got[2][3].shape == (S,)
    _compare(got, _ref(q, k, v, w, False, bias=bias))


@pytest.mark.parametrize("causal", [False, True])
def test_segment_ids_match_interpret_kernels(causal):
    q, k, v = _qkv(5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    segs = np.stack([np.repeat(np.arange(4), 32),
                     np.repeat(np.arange(2), 64)]).astype(np.int32)
    _compare(_port(q, k, v, w, causal, segs=segs),
             _ref(q, k, v, w, causal, segs=segs))


def test_bias_and_segment_ids_together():
    q, k, v = _qkv(7)
    rng = np.random.default_rng(8)
    bias = rng.standard_normal((1, H, S, S)).astype(np.float32)
    w = rng.standard_normal(q.shape).astype(np.float32)
    segs = np.stack([np.repeat(np.arange(2), 64)] * B).astype(np.int32)
    _compare(_port(q, k, v, w, True, bias=bias, segs=segs),
             _ref(q, k, v, w, True, bias=bias, segs=segs))


def test_bool_padding_mask_matches_interpret_kernels():
    # (B, 1, 1, Sk) bool from per-sample lengths, True = attend: the
    # padded-batch layout; the mask takes no gradient
    q, k, v = _qkv(9)
    w = np.random.default_rng(10).standard_normal(q.shape).astype(np.float32)
    lens = np.array([100, 71])
    mask = (np.arange(S)[None, :] < lens[:, None]).reshape(B, 1, 1, S)
    _compare(_port(q, k, v, w, False, bias=mask),
             _ref(q, k, v, w, False, bias=mask))


def test_fully_masked_rows_give_exact_zeros():
    # a bool mask that hides every key of some query rows: out = 0 exactly,
    # lse = -inf, and those rows add nothing to any gradient
    q, k, v = _qkv(11)
    w = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    mask = np.ones((B, 1, S, S), dtype=bool)
    mask[0, :, :40] = False
    mask[1, :, 90:] = False
    got = _port(q, k, v, w, False, bias=mask)
    out, lse, grads = got
    assert np.all(out[0, :40] == 0) and np.all(out[1, 90:] == 0)
    assert np.all(np.isneginf(lse[:H, :40])) and np.all(
        np.isneginf(lse[H:, 90:]))
    assert np.all(grads[0][0, :40] == 0) and np.all(grads[0][1, 90:] == 0)
    _compare(got, _ref(q, k, v, w, False, bias=mask))


def test_finite_large_negative_bias_is_not_minus_inf():
    # BERT's padding bias is -1e30, not -inf: a row whose every key carries
    # it attends uniformly (as the reference's kernel and dense path do),
    # where a bool mask would give 0
    q, k, v = _qkv(13)
    w = np.random.default_rng(14).standard_normal(q.shape).astype(np.float32)
    bias = np.zeros((B, 1, S, S), np.float32)
    bias[0, :, :16] = -1e30
    got = _port(q, k, v, w, False, bias=bias)
    out, lse, _ = got
    assert np.all(np.isfinite(lse))
    np.testing.assert_allclose(out[0, :16], np.broadcast_to(
        v[0].mean(0), out[0, :16].shape), atol=ATOL, rtol=0)
    _compare(got, _ref(q, k, v, w, False, bias=bias))


# Shapes where the bf16 kernel's 128 x 128 tiles meet the masks: several
# key tiles crossed by the causal diagonal under a bias row, D = 128 with a
# full bias and with segment ids, and causal sq > sk under a bias (rows
# with no key).
_EDGES = {
    "row_bias_384_causal": (384, 384, 64, (B, 1, 1, 384), False, True),
    "full_bias_d128": (256, 256, 128, (1, H, 256, 256), False, False),
    "segments_d128_causal": (256, 256, 128, None, True, True),
    "bias_sq_gt_sk_causal": (256, 128, 64, (B, H, 256, 128), False, True),
}


@pytest.mark.parametrize("name", sorted(_EDGES))
def test_masked_tile_edges_match_interpret_kernels(name):
    sq, sk, d, bias_shape, segs, causal = _EDGES[name]
    rng = np.random.default_rng(22)
    q = rng.standard_normal((B, sq, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, sk, H, d)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal(q.shape).astype(np.float32)
    bias = (None if bias_shape is None
            else rng.standard_normal(bias_shape).astype(np.float32))
    ids = (np.stack([np.repeat(np.arange(4), sq // 4)] * B).astype(np.int32)
           if segs else None)
    got = _port(q, k, v, w, causal, bias=bias, segs=ids)
    if sq > sk:
        assert np.all(got[0][:, :sq - sk] == 0)
        assert np.all(np.isneginf(got[1][:, :sq - sk]))
    _compare(got, _ref(q, k, v, w, causal, bias=bias, segs=ids))


def test_mask_args_keep_aligned_tensors_and_copy_the_others():
    # the bf16 forward reads bias rows and key ids in 16-byte units: the
    # wrapper passes an aligned mask as it is and a view off that grain as
    # an aligned copy
    qt = torch.zeros(B * H, S, D)
    base = torch.randn(B * S + 1)
    ids = torch.zeros(B * S + 1, dtype=torch.int32)
    for off in (0, 1):
        bias = base[off:off + B * S].view(B, 1, 1, S)
        seg = ids[off:off + B * S].view(B, S)
        mask = tfa.Mask(bias, seg, seg, H)
        (tb, tq, tk), ints = tfa._mask_args(mask, qt, S, S)
        assert ints == (0, B, 1, 1, H)
        for got, given in ((tb, bias), (tq, seg), (tk, seg)):
            assert got.data_ptr() % 16 == 0 and torch.equal(got, given)
            assert (got is given) == (off == 0)


def test_plain_dbias_reduces_like_the_kernel_grid():
    # the dbias plain version on the folded residuals against the reference
    # gradient, for a bf16 bias: the result keeps the bias's dtype
    q, k, v = _qkv(15)
    rng = np.random.default_rng(16)
    bias = rng.standard_normal((1, H, S, S)).astype(np.float32)
    w = rng.standard_normal(q.shape).astype(np.float32)
    qt, kt, vt, dot = (tfa._fold(torch.from_numpy(a)) for a in (q, k, v, w))
    for dtype in (torch.float32, torch.bfloat16):
        mask = tfa.Mask(torch.from_numpy(bias).to(dtype), None, None, H)
        ot, lse = tfa.flash_attention_reference(qt, kt, vt, SCALE, False,
                                                mask)
        db = tfa.flash_attention_dbias_reference(qt, kt, vt, ot, lse, dot,
                                                 SCALE, False, mask)
        assert db.dtype == dtype and db.shape == (1, H, S, S)
        if dtype == torch.float32:
            want = _ref(q, k, v, w, False, bias=bias)[2][3]
            np.testing.assert_allclose(db.numpy(), want, atol=ATOL_GRAD,
                                       rtol=0)


@pytest.mark.parametrize("kw,want", [
    (dict(bias_shape=(2, 1, 1, 256)), True),
    (dict(bias_shape=(1, 4, 256, 256)), True),
    (dict(bias_shape=(2, 4, 256, 256)), True),
    (dict(bias_shape=(256,)), True),
    (dict(bias_shape=(2, 1, 1, 128)), False),     # key dim must be full
    (dict(bias_shape=(3, 1, 1, 256)), False),     # odd broadcast extent
    (dict(), False),                              # a mask it cannot express
    (dict(segments=True), True),
])
def test_supported_follows_reference_mask_rule(kw, want):
    q = (2, 256, 4, 64)
    assert tfa.supported(q, q, False, **kw) is want
    assert jfa.supported(q, q, False, **kw) is want


@pytest.mark.parametrize("s", [200, 384 - 64])
def test_masked_tails_go_to_the_dense_path(s):
    # masked calls need both lengths a multiple of 128 (the reference's
    # bias tiles are not tail-masked); unmasked calls take tails
    q = (2, s, 4, 64)
    assert tfa.supported(q, q, True)
    assert not tfa.supported(q, q, False, bias_shape=(2, 1, 1, s))
    assert not tfa.supported(q, q, False, segments=True)


def test_bias_that_cannot_be_canonical_raises():
    q = torch.zeros(B, S, H, D)
    with pytest.raises(ValueError, match="canonical"):
        tfa.flash_attention(q, q, q, bias=torch.zeros(B, 1, 1, S // 2))
    with pytest.raises(ValueError, match="both segment-id arrays"):
        tfa.flash_attention(q, q, q, q_segment_ids=torch.zeros(B, S))


def test_masked_cpu_path_counts_no_launch():
    names = ("launches", "launches_dq", "launches_dkv", "launches_masked",
             "launches_dq_masked", "launches_dkv_masked", "launches_dbias")
    before = [getattr(tfa, n) for n in names]
    q, k, v = _qkv(17)
    bias = np.zeros((1, H, S, S), np.float32)
    _port(q, k, v, q, False, bias=bias)
    assert [getattr(tfa, n) for n in names] == before


# The card check's measure of a bf16 dbias (chip_smoke.py and
# tests/test_torch_cuda_kernels.py): max |got - want| / (|want| + rms(want)),
# held to TOL_DBIAS_BF16.  chip_smoke.dbias_faults plants the faults a tiled
# reduction can make into the plain version; each must read above the
# limit.  The smallest, one of 128 reduced batch terms dropped, is read at
# the learned-bias encoder's (1, H, S, S) class with B = 128 (two heads
# here; chip_smoke.py reads the same faults at twelve).
def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grad_err(a, b):
    a, b = a.float(), b.float()
    rms = b.pow(2).mean().sqrt()
    return float(((a - b).abs() / (b.abs() + rms)).max())


_DBIAS_FAULTS = ["skips the last reduced term",
                 "leaves a 128x128 output tile unwritten"]


@pytest.mark.parametrize("b,bias_shape,causal,extra", [
    # the encoder's class (two heads here), 128 batch terms in 64 runs
    (128, (1, 2, 128, 128), False,
     ["drops split 32 of 64 from the ordered pass",
      "a tile reads the next bias slice"]),
    # one query row: q tiles reduced too; 8 slices in 8 runs of 1
    (4, (1, 1, 1, 128), False, ["drops split 4 of 8 from the ordered pass"]),
    # nothing reduced; causal
    (4, (4, 2, 128, 128), True, ["a tile reads the next bias slice",
                                 "skips a causal diagonal tile"]),
    # one query row per batch entry, heads reduced, causal
    (4, (4, 1, 1, 256), True, ["drops split 1 of 2 from the ordered pass",
                               "a tile reads the next bias slice",
                               "skips a causal diagonal tile"]),
])
def test_dbias_measure_flags_planted_faults(b, bias_shape, causal, extra):
    cs = _chip_smoke()
    rng = np.random.default_rng(18)
    s = bias_shape[-1]
    qt, kt, vt, dot = (torch.from_numpy(rng.standard_normal(
        (b * 2, s, 64)).astype(np.float32)).bfloat16() for _ in range(4))
    mask = tfa.Mask(torch.from_numpy(rng.standard_normal(bias_shape).astype(
        np.float32)).bfloat16(), None, None, 2)
    ot, lse = tfa.flash_attention_reference(qt, kt, vt, SCALE, causal, mask)
    want = tfa.flash_attention_dbias_reference(qt, kt, vt, ot, lse, dot,
                                               SCALE, causal, mask)
    faults = cs.dbias_faults(tfa, qt, kt, vt, ot, lse, dot, SCALE, causal,
                             mask)
    assert [name for name, _ in faults] == _DBIAS_FAULTS + extra
    for name, bad in faults:
        assert bad.dtype == want.dtype and bad.shape == want.shape
        assert _grad_err(bad, want) > cs.TOL_DBIAS_BF16, name


# The bf16 dbias kernel sums each output tile's reduced slices in
# contiguous runs, one block a (tile, run), the runs then summed in order:
# every slice in exactly one run, in order, and the blocks fill the card
# once where the tiles alone do not.
@pytest.mark.parametrize("b,h,s,d,bias_shape", [
    (128, 12, 128, 64, (1, 12, 128, 128)),      # the learned-bias encoder
    (128, 12, 128, 64, (1, 1, 128, 128)),
    (128, 12, 128, 64, (128, 1, 1, 128)),
    (128, 12, 128, 64, (128, 12, 128, 128)),
    (4, 4, 256, 64, (1, 1, 1, 256)),
    (20, 4, 256, 64, (1, 4, 256, 256)),
    (23, 3, 256, 64, (1, 1, 1, 256)),
    (21, 4, 256, 128, (1, 4, 256, 256)),
    (5000, 14, 128, 64, (5000, 14, 128, 128)),
    (1, 1, 128, 64, (1, 1, 1, 128)),
])
def test_dbias_split_covers_every_reduced_slice_once(b, h, s, d, bias_shape):
    mask = tfa.Mask(torch.zeros(bias_shape), None, None, h)
    n_r, n_tiles, per, n_split = tfa.dbias_plan(mask, b * h, s, s, d)
    bb, hb, _, _ = bias_shape
    assert n_r * bb * hb == b * h          # every folded slice in one sum
    runs = [range(i * per, min(n_r, (i + 1) * per)) for i in range(n_split)]
    assert [r for run in runs for r in run] == list(range(n_r))
    assert all(len(run) > 0 for run in runs) and n_split <= 65535
    if n_tiles <= 132:
        assert n_tiles * n_split <= 132
        assert 2 * n_split >= min(n_r, 132 // n_tiles)


# The functionals of nn/functional/attention.py on both sides: the kernel
# path at S = 128, the dense path below it (S = 64), where a learned bias
# is differentiated by autograd through the dense attention.
@pytest.mark.parametrize("s", [128, 64])
def test_functional_segment_ids_match_reference(s):
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as jF
    from paddle_tpu_torch.nn import functional as tF
    q, k, v = _qkv(19, s=s)
    segs = np.stack([np.repeat(np.arange(2), s // 2)] * B).astype(np.int32)
    want = jF.flash_attention(*(paddle.to_tensor(a) for a in (q, k, v)),
                              causal=True,
                              q_segment_ids=paddle.to_tensor(segs),
                              kv_segment_ids=paddle.to_tensor(segs))
    got = tF.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, q_segment_ids=torch.from_numpy(segs),
                             kv_segment_ids=torch.from_numpy(segs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [128, 64])
def test_functional_learned_bias_gradient_matches_reference(s):
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as jF
    from paddle_tpu_torch.nn import functional as tF
    q, k, v = _qkv(20, s=s)
    rng = np.random.default_rng(21)
    bias = rng.standard_normal((1, H, s, s)).astype(np.float32)
    w = rng.standard_normal(q.shape).astype(np.float32)
    jt = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v, bias)]
    (jF.scaled_dot_product_attention(*jt[:3], attn_mask=jt[3])
     * paddle.to_tensor(w)).sum().backward()
    tt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    (tF.scaled_dot_product_attention(*tt[:3], attn_mask=tt[3])
     * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), tt, jt):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b.grad._data),
                                   atol=ATOL_GRAD, rtol=0, err_msg=name)
