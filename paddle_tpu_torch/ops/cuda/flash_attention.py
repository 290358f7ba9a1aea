"""Flash attention, forward (port of paddle_tpu/ops/pallas/flash_attention.py).

Forward only, no bias and no segment ids: the path of this slice.  The
kernel is ``csrc/flash_attention_fwd.cu`` (hand-written CUDA for sm_90a),
which replaces the Pallas ``_fwd_kernel``.

Dispatch is by the device of the tensors it is given:

- a CPU tensor takes :func:`flash_attention_reference`, the plain PyTorch
  version of the same algorithm;
- a CUDA tensor launches the kernel, or raises: on a shape or dtype the
  kernel does not take, on a failed build, on a failed launch.

Semantics held from the reference: end-aligned causal masking (query i
sees key j iff j <= i + sk - sq), and a row with no visible key gives
out = 0 and lse = -inf.  Layout at the public functions is (B, S, H, D);
the kernel works on the folded (B*H, S, D) layout.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["supported", "flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "launches"]

_MIN_BLOCK = 128           # the reference's smallest block (flash_attention.py)
_KERNEL_D = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by this process (read by chip_smoke.py)
launches = 0

_fn = None


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


def flash_attention_reference(qt, kt, vt, scale: float, causal: bool):
    """Plain PyTorch version on folded (B*H, S, D) operands: the kernel's
    arithmetic, dense.  Scores in f32, p rounded to the value dtype for the
    p.v product, the row sum over the unrounded p.  Returns (out (B*H, Sq,
    D) in the input dtype, lse (B*H, Sq) f32)."""
    sq, sk = qt.shape[1], kt.shape[1]
    s = torch.einsum("bqd,bkd->bqk", qt.float(), kt.float()) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=qt.device).tril(
            sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    p = torch.where(live, torch.exp(s - torch.where(live, m, 0.0)), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p.to(vt.dtype).float(), vt.float())
    out = acc / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      float("-inf"))
    return out.to(qt.dtype), lse[..., 0]


def _kernel():
    global _fn
    if _fn is None:
        from paddle_tpu_torch.ops.cuda import _build
        fn = _build.load("flash_attention_fwd").pt_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(qt, kt, vt, scale: float, causal: bool):
    global launches
    bh, sq, d = qt.shape
    sk = kt.shape[1]
    for name, t in (("q", qt), ("k", kt), ("v", vt)):
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
    if bh > 65535:
        raise ValueError(f"flash_attention: B*H={bh} exceeds the kernel's "
                         "grid (65535)")
    out = torch.empty_like(qt)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=qt.device)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
                        _DTYPES[qt.dtype], int(causal), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"cudaError {err}")
    launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """(B, S, H, D) q, k, v → (out (B, Sq, H, D), lse (B*H, Sq) f32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("backward: next slice")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, _, h, _ = q.shape
    qt, kt, vt = _fold(q), _fold(k), _fold(v)
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(qt, kt, vt, scale, causal)
    elif q.device.type == "cuda":
        out, lse = _launch(qt, kt, vt, scale, causal)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _unfold(out, b, h), lse


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Blockwise attention, (B, S, H, D) layout (reference ``:846``, no bias
    and no segment ids)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
