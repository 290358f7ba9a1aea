"""Flash attention, forward and backward (port of
paddle_tpu/ops/pallas/flash_attention.py).

No bias and no segment ids: the path of the GPT slices.  The kernels are
hand-written CUDA for sm_90a: ``csrc/flash_attention_fwd.cu`` replaces the
Pallas ``_fwd_kernel``, ``csrc/flash_attention_bwd.cu`` the
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``.  :class:`_FlashAttention`
ties them together as ``_flash`` / ``_fa_fwd`` / ``_fa_bwd`` do in the
reference: the forward saves the folded q, k, v, the folded output and
lse; the backward computes ``delta = rowsum(do * o)`` in f32 and runs the
dq and dk/dv passes.

Dispatch is by the device of the tensors it is given:

- a CPU tensor takes the plain PyTorch versions,
  :func:`flash_attention_reference` and
  :func:`flash_attention_bwd_reference`;
- a CUDA tensor launches the kernels, or raises: on a shape or dtype the
  kernels do not take, on a failed build, on a failed launch.

Semantics held from the reference: end-aligned causal masking (query i
sees key j iff j <= i + sk - sq), and a row with no visible key gives
out = 0, lse = -inf and zero gradients.  Layout at the public functions
is (B, S, H, D); the kernels work on the folded (B*H, S, D) layout.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["supported", "flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "launches", "launches_dq", "launches_dkv"]

_MIN_BLOCK = 128           # the reference's smallest block (flash_attention.py)
_KERNEL_D = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by this process (read by chip_smoke.py): the
# forward, the backward's dq pass and its dk/dv pass
launches = 0
launches_dq = 0
launches_dkv = 0

_fns: dict = {}


def supported(q_shape, k_shape, causal: bool = False) -> bool:
    """The reference's dispatch rule (``supported`` :93, no mask): the
    blockwise kernel serves sequences of at least one block and, when
    causal, no more queries than keys; shorter sequences go to the dense
    fallback (nn/functional/attention.py).  Head dims the CUDA kernel
    does not take (other than 64 and 128) pass this rule and then raise
    in the wrapper."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    _, sq, _, d = q_shape
    sk = k_shape[1]
    if causal and sq > sk:
        return False
    if d % 128 != 0 and d != 64:
        return False
    return sq >= _MIN_BLOCK and sk >= _MIN_BLOCK


def _fold(x):
    """(B, S, H, D) → (B*H, S, D)."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).contiguous().view(b * h, s, d)


def _unfold(x, b, h):
    """(B*H, S, D) → (B, S, H, D)."""
    _, s, d = x.shape
    return x.view(b, h, s, d).permute(0, 2, 1, 3)


def _scores(qt, kt, scale: float, causal: bool):
    """f32 scores of the input-dtype products, masked to -inf where the
    end-aligned causal mask hides the key."""
    sq, sk = qt.shape[1], kt.shape[1]
    s = torch.einsum("bqd,bkd->bqk", qt.float(), kt.float()) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=qt.device).tril(
            sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_attention_reference(qt, kt, vt, scale: float, causal: bool):
    """Plain PyTorch version on folded (B*H, S, D) operands: the kernel's
    arithmetic, dense.  Scores in f32, p rounded to the value dtype for the
    p.v product, the row sum over the unrounded p.  Returns (out (B*H, Sq,
    D) in the input dtype, lse (B*H, Sq) f32)."""
    s = _scores(qt, kt, scale, causal)
    m = s.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    p = torch.where(live, torch.exp(s - torch.where(live, m, 0.0)), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p.to(vt.dtype).float(), vt.float())
    out = acc / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      float("-inf"))
    return out.to(qt.dtype), lse[..., 0]


def _delta(dot, ot):
    """delta = rowsum(do * o) in f32, (B*H, Sq): the softmax Jacobian's row
    term, an O(S*D) precompute (reference ``:636-639``)."""
    return (dot.float() * ot.float()).sum(-1)


def flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot, scale: float,
                                  causal: bool):
    """Plain PyTorch version of the backward on folded operands, dense:
    p rebuilt from lse (0 on a row with lse = -inf, reference
    ``_rebuild_p`` :396), ``ds = p * (dp - delta)``; p and ds rounded to
    the input dtype before the products that take them, every product
    accumulated in f32.  Returns (dq, dk, dv) in the input dtype."""
    dt = qt.dtype
    s = _scores(qt, kt, scale, causal)
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None],
                                                    0.0)), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", dot.float(), vt.float())
    ds = p * (dp - _delta(dot, ot)[..., None])
    ds_r = ds.to(dt).float()
    dq = torch.einsum("bqk,bkd->bqd", ds_r, kt.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds_r, qt.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", p.to(dt).float(), dot.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _kernel(name: str):
    """The ctypes function ``name`` of its kernel library, typed."""
    fn = _fns.get(name)
    if fn is None:
        from paddle_tpu_torch.ops.cuda import _build
        if name == "fwd":
            fn = _build.load("flash_attention_fwd").pt_flash_attention_fwd
            ptrs = 5
        else:
            lib = _build.load("flash_attention_bwd")
            fn = getattr(lib, f"pt_flash_attention_bwd_{name}")
            ptrs = 7 if name == "dq" else 8
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * 6 + [
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
    if bh > 65535:
        raise ValueError(f"flash_attention: B*H={bh} exceeds the kernel's "
                         "grid (65535)")
    return bh, sq, sk, d


def _rows(name, t, bh, sq):
    """lse / delta: contiguous (bh, sq) f32 on the card."""
    if t.dtype != torch.float32 or tuple(t.shape) != (bh, sq) or \
            not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"flash_attention: {name} must be a contiguous "
                         f"({bh}, {sq}) float32 CUDA tensor")


def _call(name, tensors, ints, scale: float):
    """Launch kernel ``name`` on the current stream of the tensors' card;
    raise if the launch is refused."""
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*(t.data_ptr() for t in tensors), *ints,
                            float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: {name} kernel launch failed "
                           f"with cudaError {err}")


def _launch(qt, kt, vt, scale: float, causal: bool):
    """Forward kernel: (out, lse) of folded q, k, v on the card."""
    global launches
    bh, sq, sk, d = _check(qt, kt, vt)
    out = torch.empty_like(qt)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=qt.device)
    _call("fwd", (qt, kt, vt, out, lse),
          (bh, sq, sk, d, _DTYPES[qt.dtype], int(causal)), scale)
    launches += 1
    return out, lse


def _launch_dq(qt, kt, vt, dot, lse, delta, scale: float, causal: bool):
    """dq kernel on the card (reference ``_bwd_dq_kernel`` :452)."""
    global launches_dq
    bh, sq, sk, d = _check(qt, kt, vt, dot)
    _rows("lse", lse, bh, sq)
    _rows("delta", delta, bh, sq)
    dq = torch.empty_like(qt)
    _call("dq", (qt, kt, vt, dot, lse, delta, dq),
          (bh, sq, sk, d, _DTYPES[qt.dtype], int(causal)), scale)
    launches_dq += 1
    return dq


def _launch_dkv(qt, kt, vt, dot, lse, delta, scale: float, causal: bool):
    """dk/dv kernel on the card (reference ``_bwd_dkv_kernel`` :498)."""
    global launches_dkv
    bh, sq, sk, d = _check(qt, kt, vt, dot)
    _rows("lse", lse, bh, sq)
    _rows("delta", delta, bh, sq)
    dk, dv = torch.empty_like(kt), torch.empty_like(vt)
    _call("dkv", (qt, kt, vt, dot, lse, delta, dk, dv),
          (bh, sq, sk, d, _DTYPES[qt.dtype], int(causal)), scale)
    launches_dkv += 1
    return dk, dv


def _launch_bwd(qt, kt, vt, ot, lse, dot, scale: float, causal: bool):
    """Both backward kernels on the card: (dq, dk, dv)."""
    delta = _delta(dot, ot)
    dq = _launch_dq(qt, kt, vt, dot, lse, delta, scale, causal)
    return (dq, *_launch_dkv(qt, kt, vt, dot, lse, delta, scale, causal))


def _by_device(t, cpu, cuda):
    if t.device.type == "cpu":
        return cpu
    if t.device.type == "cuda":
        return cuda
    raise ValueError(f"flash_attention: unsupported device {t.device}")


class _FlashAttention(torch.autograd.Function):
    """Folded flash attention with its backward (reference ``_flash``
    :783, ``_fa_fwd`` :789, ``_fa_bwd`` :808)."""

    @staticmethod
    def forward(ctx, qt, kt, vt, scale, causal):
        fwd = _by_device(qt, flash_attention_reference, _launch)
        out, lse = fwd(qt, kt, vt, scale, causal)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, _dlse):
        qt, kt, vt, ot, lse = ctx.saved_tensors
        bwd = _by_device(qt, flash_attention_bwd_reference, _launch_bwd)
        dq, dk, dv = bwd(qt, kt, vt, ot, lse, dout.contiguous(), ctx.scale,
                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """(B, S, H, D) q, k, v → (out (B, Sq, H, D), lse (B*H, Sq) f32).
    Differentiable in q, k, v; under no_grad or inference_mode nothing is
    recorded and the residuals are dropped."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, _, h, _ = q.shape
    out, lse = _FlashAttention.apply(_fold(q), _fold(k), _fold(v),
                                     float(scale), bool(causal))
    return _unfold(out, b, h), lse


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Blockwise attention, (B, S, H, D) layout (reference ``:846``, no bias
    and no segment ids)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
