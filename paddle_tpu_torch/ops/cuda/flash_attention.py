"""Flash attention, forward and backward, with an optional additive bias
and segment ids (port of paddle_tpu/ops/pallas/flash_attention.py).

The kernels are hand-written CUDA for sm_90a: ``csrc/flash_attention_fwd.cu``
replaces the Pallas ``_fwd_kernel``, ``csrc/flash_attention_bwd.cu`` the
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, ``csrc/flash_attention_dbias.cu``
the ``_bwd_dbias_kernel``.  Two ``torch.library`` custom ops tie them
together as ``_flash`` / ``_fa_fwd`` / ``_fa_bwd`` do in the reference:
``paddle_tpu_torch::flash_fwd`` (:func:`flash_fwd_op`) gives out and lse
and saves the folded q, k, v, the folded output, lse and the masks;
``paddle_tpu_torch::flash_bwd`` (:func:`flash_bwd_op`, its registered
backward) computes ``delta = rowsum(do * o)`` in f32 and runs the dq and
dk/dv passes, and the dbias pass only when the bias needs a gradient
(``ctx.needs_input_grad``), as the reference's ``_flash`` and
``_flash_nodbias`` split it: a padding mask never launches it.  Being
custom ops with fake (shape) implementations, both stay nodes of a graph
that ``torch.export`` captures (``jit.to_static``, ``jit.save``), and
their launches are counted there too.

Masks (reference ``flash_attention`` :846): ``bias`` broadcastable to
(B, H, Sq, Sk), each leading dim full or 1 and the key dim full, is
canonicalised to (Bb, Hb, Sqb, Sk); a bool mask (True = attend) becomes a
0 / -inf f32 bias, any other dtype but bf16 becomes f32.  Segment ids
(B, Sq) / (B, Sk), both or neither, hide the pairs whose ids differ.  The
score is ``s * scale + bias``, then -inf where the ids differ, then the
causal mask.

Dispatch is by the device of the tensors it is given (each op's kernel
registered for "cpu" and for "cuda"):

- a CPU tensor takes the plain PyTorch versions,
  :func:`flash_attention_reference`, :func:`flash_attention_bwd_reference`
  and :func:`flash_attention_dbias_reference`;
- a CUDA tensor launches the kernels, or raises: on a shape or dtype the
  kernels do not take (a masked call whose sequences are not multiples of
  128 among them), on a failed build, on a failed launch.

Semantics held from the reference: end-aligned causal masking (query i
sees key j iff j <= i + sk - sq), and a row with no visible key gives
out = 0, lse = -inf and zero gradients (a bool mask's -inf rows included;
a finite bias such as BERT's -1e30 is not -inf).  Layout at the public
functions is (B, S, H, D); the kernels work on the folded (B*H, S, D)
layout.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["supported", "flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "flash_attention_dbias_reference", "Mask", "dbias_plan",
           "launches", "launches_dq", "launches_dkv", "launches_masked",
           "launches_dq_masked", "launches_dkv_masked", "launches_dbias"]

_MIN_BLOCK = 128           # the reference's smallest block (flash_attention.py)
_KERNEL_D = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by this process (read by chip_smoke.py): the
# forward, the backward's dq pass and its dk/dv pass without a mask; the
# same three with a bias or segment ids (the MASKED instantiations); the
# dbias pass
launches = 0
launches_dq = 0
launches_dkv = 0
launches_masked = 0
launches_dq_masked = 0
launches_dkv_masked = 0
launches_dbias = 0
_count_lock = threading.Lock()   # ranks simulated as threads launch too

_fns: dict = {}


class Mask(NamedTuple):
    """The masks of one call in the kernels' form: ``bias`` canonical
    (Bb, Hb, Sqb, Sk) f32 or bf16, or None; ``q_seg`` (B, Sq) and
    ``kv_seg`` (B, Sk) int32, or None; ``heads`` the H of the folded
    (B*H) axis."""
    bias: Optional[torch.Tensor]
    q_seg: Optional[torch.Tensor]
    kv_seg: Optional[torch.Tensor]
    heads: int


def _canon_bias_shape(bias_shape, b, h, sq, sk):
    """(Bb, Hb, Sqb, Sk) of a broadcastable bias shape, or None when it
    cannot ride the kernel (reference ``:75``): each leading dim 1 or
    full, the key dim full."""
    s = tuple(int(d) for d in bias_shape)
    if len(s) > 4 or len(s) < 1:
        return None
    s = (1,) * (4 - len(s)) + s
    bb, hb, sqb, skb = s
    if skb != sk:
        return None
    if bb not in (1, b) or hb not in (1, h) or sqb not in (1, sq):
        return None
    return s


def supported(q_shape, k_shape, no_mask: bool = True, causal: bool = False,
              bias_shape=None, segments: bool = False, dtype=None) -> bool:
    """The reference's dispatch rule (``supported`` :93) without its TPU
    backend test and without its TPU crossover (``:113-120``, non-causal
    S < 1024 sent to XLA): that crossover is a TPU timing, not a semantic,
    and does not set the card's dispatch.  The blockwise kernel serves
    sequences of at least one block and, when causal, no more queries than
    keys; a mask must be a canonical bias (``bias_shape``) and/or segment
    ids, and then both lengths must be multiples of 128 (the reference's
    bias tiles are not tail-masked).  The head dim must be 64 or 128 and
    ``dtype`` (q's, when given) float32 or bfloat16: the kernels' own rule,
    narrower than the reference's (``:121`` admits any multiple of 128, and
    its kernels are dtype-generic).  Everything else, head dim 256 and f16
    among it, goes to the dense fallback (nn/functional/attention.py), on
    every device.  What this rule admits runs on the card, any B * H
    included."""
    if not no_mask and bias_shape is None and not segments:
        return False
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    b, sq, h, d = q_shape
    sk = k_shape[1]
    if causal and sq > sk:
        return False
    if d not in _KERNEL_D or (dtype is not None and dtype not in _DTYPES):
        return False
    if bias_shape is not None and \
            _canon_bias_shape(bias_shape, b, h, sq, sk) is None:
        return False
    if bias_shape is not None or segments:
        return (sq % _MIN_BLOCK == 0 and sk % _MIN_BLOCK == 0
                and sq >= _MIN_BLOCK and sk >= _MIN_BLOCK)
    return sq >= _MIN_BLOCK and sk >= _MIN_BLOCK


def _fold(x):
    """(B, S, H, D) → (B*H, S, D)."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).contiguous().view(b * h, s, d)


def _unfold(x, b, h):
    """(B*H, S, D) → (B, S, H, D)."""
    _, s, d = x.shape
    return x.view(b, h, s, d).permute(0, 2, 1, 3)


def _dense_bias(mask: Mask, bh: int, sq: int, sk: int):
    """The canonical bias broadcast to every folded slice: (B*H, Sq, Sk)
    f32."""
    b = bh // mask.heads
    return mask.bias.float().expand(b, mask.heads, sq, sk).reshape(bh, sq,
                                                                    sk)


def _scores(qt, kt, scale: float, causal: bool, mask: Optional[Mask] = None):
    """f32 scores of the input-dtype products, ``s * scale + bias``, then
    -inf where the segment ids differ or the end-aligned causal mask hides
    the key (reference ``_mask_tile`` :176 and ``:231-247``)."""
    bh, sq, sk = qt.shape[0], qt.shape[1], kt.shape[1]
    s = torch.einsum("bqd,bkd->bqk", qt.float(), kt.float()) * scale
    if mask is not None and mask.bias is not None:
        s = s + _dense_bias(mask, bh, sq, sk)
    if mask is not None and mask.q_seg is not None:
        qs = mask.q_seg.repeat_interleave(mask.heads, 0)
        ks = mask.kv_seg.repeat_interleave(mask.heads, 0)
        s = s.masked_fill(qs[:, :, None] != ks[:, None, :], float("-inf"))
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=qt.device).tril(
            sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_attention_reference(qt, kt, vt, scale: float, causal: bool,
                              mask: Optional[Mask] = None):
    """Plain PyTorch version on folded (B*H, S, D) operands: the kernel's
    arithmetic, dense.  Scores in f32, p rounded to the value dtype for the
    p.v product, the row sum over the unrounded p.  Returns (out (B*H, Sq,
    D) in the input dtype, lse (B*H, Sq) f32)."""
    return _attend(_scores(qt, kt, scale, causal, mask), vt, qt.dtype)


def _attend(s, vt, dtype):
    """(out in ``dtype``, lse) of the f32 masked scores s: the softmax's p
    rounded to v's dtype for the p.v product, the row sum over the
    unrounded p, a row with no visible key 0 and -inf."""
    m = s.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    p = torch.where(live, torch.exp(s - torch.where(live, m, 0.0)), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p.to(vt.dtype).float(), vt.float())
    out = acc / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      float("-inf"))
    return out.to(dtype), lse[..., 0]


def _delta(dot, ot):
    """delta = rowsum(do * o) in f32, (B*H, Sq): the softmax Jacobian's row
    term, an O(S*D) precompute (reference ``:636-639``)."""
    return (dot.float() * ot.float()).sum(-1)


def _p_ds(qt, kt, vt, ot, lse, dot, scale, causal, mask):
    """p rebuilt from lse (0 on a row with lse = -inf, reference
    ``_rebuild_p`` :396) and ``ds = p * (dp - delta)``, both f32."""
    s = _scores(qt, kt, scale, causal, mask)
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None],
                                                    0.0)), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", dot.float(), vt.float())
    return p, p * (dp - _delta(dot, ot)[..., None])


def flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot, scale: float,
                                  causal: bool, mask: Optional[Mask] = None):
    """Plain PyTorch version of the backward on folded operands, dense:
    p and ds as :func:`_p_ds` gives them, rounded to the input dtype
    before the products that take them, every product accumulated in f32.
    Returns (dq, dk, dv) in the input dtype."""
    dt = qt.dtype
    p, ds = _p_ds(qt, kt, vt, ot, lse, dot, scale, causal, mask)
    ds_r = ds.to(dt).float()
    dq = torch.einsum("bqk,bkd->bqd", ds_r, kt.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds_r, qt.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", p.to(dt).float(), dot.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_dbias_reference(qt, kt, vt, ot, lse, dot, scale: float,
                                    causal: bool, mask: Mask):
    """Plain PyTorch version of the bias gradient (reference
    ``_bwd_dbias_kernel`` :560): the unrounded f32 ds summed over the
    bias's broadcast extent (the batch and head dims where the canonical
    bias has 1, and the query rows when Sqb = 1), in the bias's dtype,
    shaped as the canonical bias."""
    _, ds = _p_ds(qt, kt, vt, ot, lse, dot, scale, causal, mask)
    return _reduce_dbias(ds, mask)


def _reduce_dbias(ds, mask: Mask):
    """f32 ds (B*H, Sq, Sk) summed over the bias's broadcast extent, in the
    bias's dtype and canonical shape."""
    bb, hb, sqb, sk = mask.bias.shape
    ds = ds.view(-1, mask.heads, ds.shape[1], sk)
    dims = [i for i, n in enumerate((bb, hb, sqb)) if n == 1]
    if dims:
        ds = ds.sum(dims, keepdim=True)
    return ds.reshape(bb, hb, sqb, sk).to(mask.bias.dtype)


# (pointers, ints) of each C entry point; a float scale and the stream
# follow
_ARGS = {"fwd": (8, 11), "dq": (10, 11), "dkv": (11, 11), "dbias": (11, 12)}
# The bf16 dbias kernel's output tile, (query rows, keys), by head dim, and
# the card's SMs: one block of that kernel is resident on each
DBIAS_TILES = {64: (128, 128), 128: (64, 64)}
_SMS = 132


def _kernel(name: str):
    """The ctypes function ``name`` of its kernel library, typed."""
    fn = _fns.get(name)
    if fn is None:
        from paddle_tpu_torch.ops.cuda import _build
        if name == "fwd":
            fn = _build.load("flash_attention_fwd").pt_flash_attention_fwd
        elif name == "dbias":
            fn = _build.load("flash_attention_dbias").pt_flash_attention_dbias
        else:
            lib = _build.load("flash_attention_bwd")
            fn = getattr(lib, f"pt_flash_attention_bwd_{name}")
        ptrs, ints = _ARGS[name]
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(qt, kt, vt, dot=None):
    """Raise on what the kernels do not take; returns (bh, sq, sk, d)."""
    bh, sq, d = qt.shape
    sk = kt.shape[1]
    named = [("q", qt), ("k", kt), ("v", vt)]
    if dot is not None:
        named.append(("do", dot))
    for name, t in named:
        if t.device.type != "cuda" or t.device != qt.device:
            raise ValueError(f"flash_attention: {name} must lie on the "
                             f"same CUDA device as q, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != qt.dtype:
            raise ValueError(f"flash_attention: the kernel takes float32 "
                             f"or bfloat16 q, k, v of one dtype, got "
                             f"{name} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: folded {name} must be "
                             "contiguous and 16-byte aligned")
    if d not in _KERNEL_D:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dim "
                         f"64 or 128, got {d}")
    if kt.shape != vt.shape or kt.shape[0] != bh or kt.shape[2] != d:
        raise ValueError(f"flash_attention: k {tuple(kt.shape)} / v "
                         f"{tuple(vt.shape)} do not match q {tuple(qt.shape)}")
    if dot is not None and dot.shape != qt.shape:
        raise ValueError(f"flash_attention: do {tuple(dot.shape)} does not "
                         f"match q {tuple(qt.shape)}")
    return bh, sq, sk, d


def _mask_args(mask: Optional[Mask], qt, sq: int, sk: int):
    """Raise on a mask the kernels do not take; returns its pointers'
    tensors (bias, q_seg, kv_seg; None where absent) and the ints
    (bias_bf16, bb, hb, sqb, heads) of the C interface."""
    if mask is None:
        return (None, None, None), (0, 1, 1, 1, 1)
    bh = qt.shape[0]
    if mask.heads <= 0 or bh % mask.heads:
        raise ValueError(f"flash_attention: B*H={bh} is not a multiple of "
                         f"heads={mask.heads}")
    if sq % _MIN_BLOCK or sk % _MIN_BLOCK:
        raise ValueError(f"flash_attention: a masked call takes sequence "
                         f"lengths that are multiples of {_MIN_BLOCK}, got "
                         f"sq={sq} sk={sk} (supported() sends them to the "
                         "dense fallback)")
    b = bh // mask.heads
    named = [("bias", mask.bias), ("q_segment_ids", mask.q_seg),
             ("kv_segment_ids", mask.kv_seg)]
    for name, t in named:
        if t is not None and (t.device != qt.device
                              or not t.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"on {qt.device}, got {t.device}")
    ints = (0, 1, 1, 1, mask.heads)
    if mask.bias is not None:
        if mask.bias.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: the kernel takes a float32 "
                             f"or bfloat16 bias, got {mask.bias.dtype}")
        if _canon_bias_shape(mask.bias.shape, b, mask.heads, sq, sk) != \
                tuple(mask.bias.shape):
            raise ValueError(f"flash_attention: bias {tuple(mask.bias.shape)}"
                             f" is not canonical for B={b} H={mask.heads} "
                             f"sq={sq} sk={sk}")
        bb, hb, sqb, _ = mask.bias.shape
        ints = (_DTYPES[mask.bias.dtype], bb, hb, sqb, mask.heads)
    if (mask.q_seg is None) != (mask.kv_seg is None):
        raise ValueError("flash_attention: pass both segment-id arrays or "
                         "neither")
    if mask.q_seg is not None:
        if (mask.q_seg.dtype != torch.int32 or mask.kv_seg.dtype != torch.int32
                or tuple(mask.q_seg.shape) != (b, sq)
                or tuple(mask.kv_seg.shape) != (b, sk)):
            raise ValueError(f"flash_attention: segment ids must be int32 "
                             f"({b}, {sq}) and ({b}, {sk})")
    # the bf16 forward and dq kernels copy bias rows and key ids into
    # shared memory in 16-byte units: a view that starts off that grain
    # rides as a copy
    return tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                 for _, t in named), ints


def _rows(name, t, bh, sq):
    """lse / delta: contiguous (bh, sq) f32 on the card."""
    if t.dtype != torch.float32 or tuple(t.shape) != (bh, sq) or \
            not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"flash_attention: {name} must be a contiguous "
                         f"({bh}, {sq}) float32 CUDA tensor")


def _call(name, tensors, ints, scale: float):
    """Launch kernel ``name`` on the current stream of the tensors' card;
    raise if the launch is refused.  A None tensor is a null pointer."""
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*(None if t is None else t.data_ptr()
                              for t in tensors), *ints, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: {name} kernel launch failed "
                           f"with cudaError {err}")


def _launch(qt, kt, vt, scale: float, causal: bool,
            mask: Optional[Mask] = None):
    """Forward kernel: (out, lse) of folded q, k, v on the card."""
    global launches, launches_masked
    bh, sq, sk, d = _check(qt, kt, vt)
    mptr, mint = _mask_args(mask, qt, sq, sk)
    out = torch.empty_like(qt)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=qt.device)
    _call("fwd", (qt, kt, vt, *mptr, out, lse),
          (bh, sq, sk, d, _DTYPES[qt.dtype], int(causal), *mint), scale)
    with _count_lock:
        if mask is None:
            launches += 1
        else:
            launches_masked += 1
    return out, lse


def _bwd_args(qt, kt, vt, dot, lse, delta, mask):
    bh, sq, sk, d = _check(qt, kt, vt, dot)
    _rows("lse", lse, bh, sq)
    _rows("delta", delta, bh, sq)
    return (bh, sq, sk, d), _mask_args(mask, qt, sq, sk)


def _launch_dq(qt, kt, vt, dot, lse, delta, scale: float, causal: bool,
               mask: Optional[Mask] = None):
    """dq kernel on the card (reference ``_bwd_dq_kernel`` :452)."""
    global launches_dq, launches_dq_masked
    (bh, sq, sk, d), (mptr, mint) = _bwd_args(qt, kt, vt, dot, lse, delta,
                                              mask)
    dq = torch.empty_like(qt)
    _call("dq", (qt, kt, vt, dot, lse, delta, *mptr, dq),
          (bh, sq, sk, d, _DTYPES[qt.dtype], int(causal), *mint), scale)
    with _count_lock:
        if mask is None:
            launches_dq += 1
        else:
            launches_dq_masked += 1
    return dq


def _launch_dkv(qt, kt, vt, dot, lse, delta, scale: float, causal: bool,
                mask: Optional[Mask] = None):
    """dk/dv kernel on the card (reference ``_bwd_dkv_kernel`` :498)."""
    global launches_dkv, launches_dkv_masked
    (bh, sq, sk, d), (mptr, mint) = _bwd_args(qt, kt, vt, dot, lse, delta,
                                              mask)
    dk, dv = torch.empty_like(kt), torch.empty_like(vt)
    _call("dkv", (qt, kt, vt, dot, lse, delta, *mptr, dk, dv),
          (bh, sq, sk, d, _DTYPES[qt.dtype], int(causal), *mint), scale)
    with _count_lock:
        if mask is None:
            launches_dkv += 1
        else:
            launches_dkv_masked += 1
    return dk, dv


def dbias_plan(mask: Mask, bh: int, sq: int, sk: int, d: int):
    """The splits of a bf16 dbias call: (n_r, n_tiles, per, n_split).
    Each of the n_tiles output tiles sums its n_r reduced folded slices
    (the C launcher's ``Reduce``) in n_split contiguous runs of ``per``
    slices, the last one shorter where per does not divide n_r, a block
    for each (tile, run); the runs are as many as fill the card's SMs once
    (one block an SM is resident)."""
    bb, hb, sqb, _ = mask.bias.shape
    n_r = (bh if bb == 1 and hb == 1 else bh // mask.heads if bb == 1
           else mask.heads if hb == 1 else 1)
    tq, tk = DBIAS_TILES[d]
    n_tiles = bb * hb * (sq // tq if sqb > 1 else 1) * (sk // tk)
    runs = max(1, min(n_r, _SMS // n_tiles))
    per = -(-n_r // runs)
    return n_r, n_tiles, per, -(-n_r // per)


def _launch_dbias(qt, kt, vt, dot, lse, delta, scale: float, causal: bool,
                  mask: Mask):
    """dbias kernel on the card (reference ``_bwd_dbias_kernel`` :560):
    the canonical bias's gradient, in its dtype.  In bf16 the reduced
    slices run in splits (:func:`dbias_plan`); with more than one, an f32
    scratch buffer holds each split's partial sums."""
    global launches_dbias
    if mask is None or mask.bias is None:
        raise ValueError("flash_attention: the dbias kernel needs a bias")
    (bh, sq, sk, d), (mptr, mint) = _bwd_args(qt, kt, vt, dot, lse, delta,
                                              mask)
    # lse and delta ride bulk copies in 16-byte units
    lse, delta = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (lse, delta))
    db = torch.empty_like(mask.bias)
    part, per = None, 1
    if qt.dtype == torch.bfloat16:
        _, _, per, n_split = dbias_plan(mask, bh, sq, sk, d)
        if n_split > 1:
            part = torch.empty((n_split,) + tuple(mask.bias.shape),
                               dtype=torch.float32, device=qt.device)
    _call("dbias", (qt, kt, vt, dot, lse, delta, *mptr, db, part),
          (bh, sq, sk, d, _DTYPES[qt.dtype], int(causal), *mint, per), scale)
    with _count_lock:
        launches_dbias += 1
    return db


def _launch_bwd(qt, kt, vt, ot, lse, dot, scale: float, causal: bool,
                mask: Optional[Mask] = None, dbias: bool = False):
    """The backward kernels on the card: (dq, dk, dv, dbias or None); the
    dbias kernel runs only when asked."""
    delta = _delta(dot, ot)
    dq = _launch_dq(qt, kt, vt, dot, lse, delta, scale, causal, mask)
    dk, dv = _launch_dkv(qt, kt, vt, dot, lse, delta, scale, causal, mask)
    db = (_launch_dbias(qt, kt, vt, dot, lse, delta, scale, causal, mask)
          if dbias else None)
    return dq, dk, dv, db


def _bwd_reference(qt, kt, vt, ot, lse, dot, scale: float, causal: bool,
                   mask: Optional[Mask] = None, dbias: bool = False):
    """The plain backward, in :func:`_launch_bwd`'s form."""
    dq, dk, dv = flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot,
                                               scale, causal, mask)
    db = (flash_attention_dbias_reference(qt, kt, vt, ot, lse, dot, scale,
                                          causal, mask) if dbias else None)
    return dq, dk, dv, db


def _check_device(t):
    """A CPU or CUDA tensor; raise on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {t.device}")


def _mask(bias, q_seg, kv_seg, heads) -> Optional[Mask]:
    if bias is None and q_seg is None:
        return None
    return Mask(bias, q_seg, kv_seg, heads)


# The two custom ops that carry #1-#4 through eager calls, captured graphs
# (torch.export keeps them as nodes) and loaded artifacts.  Each takes the
# plain version on a CPU tensor and the kernels on a CUDA tensor (their
# launches counted); the backward op runs the dbias pass only when asked.
@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                 bias: Optional[torch.Tensor], q_seg: Optional[torch.Tensor],
                 kv_seg: Optional[torch.Tensor], heads: int, scale: float,
                 causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of folded (B*H, S, D) q, k, v (reference ``_fa_fwd``
    :789)."""
    raise ValueError(f"flash_attention: unsupported device {qt.device}")


@flash_fwd_op.register_kernel("cpu")
def _(qt, kt, vt, bias, q_seg, kv_seg, heads, scale, causal):
    out, lse = flash_attention_reference(qt, kt, vt, scale, causal,
                                         _mask(bias, q_seg, kv_seg, heads))
    return out, lse.contiguous().clone()


@flash_fwd_op.register_kernel("cuda")
def _(qt, kt, vt, bias, q_seg, kv_seg, heads, scale, causal):
    return _launch(qt, kt, vt, scale, causal,
                   _mask(bias, q_seg, kv_seg, heads))


@flash_fwd_op.register_fake
def _(qt, kt, vt, bias, q_seg, kv_seg, heads, scale, causal):
    return (torch.empty_like(qt),
            qt.new_empty(qt.shape[:2], dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_bwd", mutates_args=())
def flash_bwd_op(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                 ot: torch.Tensor, lse: torch.Tensor, dot: torch.Tensor,
                 bias: Optional[torch.Tensor], q_seg: Optional[torch.Tensor],
                 kv_seg: Optional[torch.Tensor], heads: int, scale: float,
                 causal: bool, dbias: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """(dq, dk, dv, dbias) of the folded operands (reference ``_fa_bwd``
    :808); dbias is an empty tensor unless ``dbias``."""
    raise ValueError(f"flash_attention: unsupported device {qt.device}")


def _bwd_by(fn):
    def impl(qt, kt, vt, ot, lse, dot, bias, q_seg, kv_seg, heads, scale,
             causal, dbias):
        dq, dk, dv, db = fn(qt, kt, vt, ot, lse, dot, scale, causal,
                            _mask(bias, q_seg, kv_seg, heads), dbias=dbias)
        return dq, dk, dv, (qt.new_empty(0) if db is None else db)
    return impl


flash_bwd_op.register_kernel("cpu")(_bwd_by(_bwd_reference))
flash_bwd_op.register_kernel("cuda")(_bwd_by(_launch_bwd))


@flash_bwd_op.register_fake
def _(qt, kt, vt, ot, lse, dot, bias, q_seg, kv_seg, heads, scale, causal,
      dbias):
    db = torch.empty_like(bias) if dbias else qt.new_empty(0)
    return (torch.empty_like(qt), torch.empty_like(kt),
            torch.empty_like(vt), db)


def _fa_setup(ctx, inputs, output):
    qt, kt, vt, bias, q_seg, kv_seg, heads, scale, causal = inputs
    out, lse = output
    ctx.save_for_backward(qt, kt, vt, out, lse, bias, q_seg, kv_seg)
    ctx.heads, ctx.scale, ctx.causal = heads, scale, causal
    ctx.mark_non_differentiable(lse)


def _fa_backward(ctx, dout, _dlse):
    qt, kt, vt, ot, lse, bias, q_seg, kv_seg = ctx.saved_tensors
    want = bias is not None and ctx.needs_input_grad[3]
    dq, dk, dv, db = flash_bwd_op(qt, kt, vt, ot, lse, dout.contiguous(),
                                  bias, q_seg, kv_seg, ctx.heads, ctx.scale,
                                  ctx.causal, want)
    return dq, dk, dv, (db if want else None), None, None, None, None, None


flash_fwd_op.register_autograd(_fa_backward, setup_context=_fa_setup)


def _canon_bias(bias, b, h, sq, sk):
    """The bias in the kernels' form (reference ``:864-877``): canonical
    (Bb, Hb, Sqb, Sk), bool -> 0 / -inf f32, any other dtype but bf16 ->
    f32, contiguous.  Raises on a shape that cannot be made canonical."""
    canon = _canon_bias_shape(bias.shape, b, h, sq, sk)
    if canon is None:
        raise ValueError(f"flash_attention: bias shape {tuple(bias.shape)} "
                         f"is not broadcastable-canonical for "
                         f"q({b}, {sq}, {h}, .) / k(., {sk}, ., .)")
    if bias.dtype == torch.bool:
        bias = torch.zeros(bias.shape, dtype=torch.float32,
                           device=bias.device).masked_fill(~bias,
                                                           float("-inf"))
    elif bias.dtype != torch.bfloat16:
        bias = bias.to(torch.float32)
    return bias.reshape(canon).contiguous()


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None,
                        bias=None, q_segment_ids=None, kv_segment_ids=None):
    """(B, S, H, D) q, k, v → (out (B, Sq, H, D), lse (B*H, Sq) f32).
    Differentiable in q, k, v and the bias; under no_grad or
    inference_mode nothing is recorded and the residuals are dropped."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    if bias is not None:
        bias = _canon_bias(bias, b, h, sq, sk)
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: pass both segment-id arrays or "
                         "neither")
    if q_segment_ids is not None:
        q_segment_ids = torch.as_tensor(q_segment_ids, device=q.device).to(
            torch.int32).contiguous()
        kv_segment_ids = torch.as_tensor(kv_segment_ids,
                                         device=q.device).to(
            torch.int32).contiguous()
    _check_device(q)
    out, lse = flash_fwd_op(_fold(q), _fold(k), _fold(v), bias,
                            q_segment_ids, kv_segment_ids, h, float(scale),
                            bool(causal))
    return _unfold(out, b, h), lse


def flash_attention(q, k, v, causal: bool = False, scale=None, bias=None,
                    q_segment_ids=None, kv_segment_ids=None):
    """Blockwise attention, (B, S, H, D) layout, with an optional additive
    or bool ``bias`` broadcastable to (B, H, Sq, Sk) and optional segment
    ids (reference ``:846``).  The bias receives a gradient when it
    requires one (the dbias kernel); a padding mask, which does not, never
    launches it."""
    return flash_attention_fwd(q, k, v, causal, scale, bias, q_segment_ids,
                               kv_segment_ids)[0]
