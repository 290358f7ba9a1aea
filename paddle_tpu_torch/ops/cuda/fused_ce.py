"""Fused linear + softmax cross-entropy, forward (port of
paddle_tpu/ops/pallas/fused_ce.py).

Per-token ``-log softmax(h @ W.T)[label]`` without the (N, V) logits in
device memory.  The kernel is ``csrc/fused_ce_fwd.cu`` (hand-written CUDA
for sm_90a), which replaces the Pallas ``_fwd_kernel`` (the logz pass);
the gold logit ``h.W[label]`` is an O(N*H) gather outside the kernel, as
in the reference.

Forward only: a call that needs a gradient raises NotImplementedError.
A CPU tensor takes :func:`ce_logz_reference`, the plain PyTorch version;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["supported", "ce_logz", "ce_logz_reference",
           "fused_linear_cross_entropy", "xla_reference", "launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (tokens per block, vocab rows per tile) of the CUDA kernel, by dtype
_BLOCKS = {torch.float32: (64, 64), torch.bfloat16: (128, 128)}
_TARGET_BLOCKS = 4 * 132   # a few resident 256-thread blocks on each SM

# kernel launches made by this process (read by chip_smoke.py)
launches = 0

_fn = None


def supported(n: int, h: int) -> bool:
    """The reference's rule (``supported`` :52): any token count, a hidden
    width that is a multiple of 128."""
    return n >= 0 and h % 128 == 0


def ce_logz_reference(h, w):
    """Plain PyTorch version: logz (N,) f32 = logsumexp over the V rows of
    W of the f32 logits ``h @ W.T`` (the products of the input dtype,
    accumulated in f32)."""
    return torch.logsumexp(h.float() @ w.float().T, dim=-1)


def _n_split(n: int, v: int, dtype) -> int:
    """Vocab splits of the grid: enough blocks to fill the card."""
    block_n, block_v = _BLOCKS[dtype]
    n_tiles = -(-n // block_n)
    n_vt = -(-v // block_v)
    return max(1, min(n_vt, -(-_TARGET_BLOCKS // n_tiles)))


def _kernel():
    global _fn
    if _fn is None:
        from paddle_tpu_torch.ops.cuda import _build
        fn = _build.load("fused_ce_fwd").pt_ce_logz_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(h, w):
    global launches
    for name, t in (("h", h), ("w", w)):
        if t.device.type != "cuda" or t.device != h.device:
            raise ValueError(f"fused_ce: {name} must lie on the same CUDA "
                             f"device as h, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != h.dtype:
            raise ValueError(f"fused_ce: the kernel takes float32 or "
                             f"bfloat16 h and w of one dtype, got {name} "
                             f"{t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"fused_ce: {name} must be a contiguous 2-D "
                             "tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_ce: {name} must be 16-byte aligned")
    n, hd = h.shape
    v = w.shape[0]
    if w.shape[1] != hd:
        raise ValueError(f"fused_ce: w {tuple(w.shape)} does not match h "
                         f"{tuple(h.shape)}")
    if v == 0:
        raise ValueError("fused_ce: empty vocabulary")
    if h.dtype == torch.bfloat16 and hd % 64:
        raise ValueError(f"fused_ce: the bf16 kernel takes a hidden width "
                         f"that is a multiple of 64, got {hd}")
    n_split = _n_split(n, v, h.dtype)
    logz = torch.empty(n, dtype=torch.float32, device=h.device)
    part = torch.empty(2, n_split, n, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(h.data_ptr(), w.data_ptr(), logz.data_ptr(),
                        part[0].data_ptr(), part[1].data_ptr(), n, hd, v,
                        n_split, _DTYPES[h.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_ce: kernel launch failed with cudaError "
                           f"{err}")
    launches += 1
    return logz


def ce_logz(h, w):
    """logz (N,) f32 of ``h @ w.T`` over the V rows of w, by device."""
    if h.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=h.device)
    if h.device.type == "cpu":
        return ce_logz_reference(h, w)
    if h.device.type == "cuda":
        return _launch(h, w)
    raise ValueError(f"fused_ce: unsupported device {h.device}")


def fused_linear_cross_entropy(h, w, labels):
    """Per-token ``-log softmax(h @ w.T)[label]`` (reference ``:312``).

    h (N, H), w (V, H), labels (N,) integer ids.  Negative ids are
    padding: their entry is computed against class 0 and is the caller's
    to mask.  Returns (N,) float32.
    """
    if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
        raise NotImplementedError("backward: next slice")
    v = w.shape[0]
    logz = ce_logz(h, w)
    gold_w = w[labels.long().clamp(0, v - 1)]
    gold = (h.float() * gold_w.float()).sum(-1)
    return logz - gold


def xla_reference(h, w, labels):
    """Unfused version that materialises the logits (reference ``:333``)."""
    lg = (h @ w.T).float()
    logz = torch.logsumexp(lg, dim=-1)
    lab = labels.long().clamp(0, w.shape[0] - 1)
    return logz - lg.gather(-1, lab[:, None])[:, 0]
