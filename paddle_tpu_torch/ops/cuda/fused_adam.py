"""Fused Adam / AdamW update over many tensors (port of
paddle_tpu/ops/pallas/fused_adam.py).

One pass over (p, g, m, v) of every parameter gives (p', m', v'),
computed in f32 from the values widened to f32:

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g g
    p' = p - lr_t m' / (sqrt(v') + eps) - wd_lr p

with ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)`` per tensor (its own beta
pows) and ``wd_lr = lr * coeff`` for AdamW's decoupled decay (0 for Adam).
The kernel is ``csrc/fused_adam.cu`` (hand-written CUDA for sm_90a), which
replaces the Pallas ``_adam_kernel``: where the reference launches it once
per tensor, one launch here updates up to 32 tensors (a multi-tensor
apply).  It has two instantiations: f32 storage, and bf16 storage (the
parameters and moments that ``amp.decorate(level="O2")`` leaves), which
reads bf16, computes in f32 and stores p', m', v' rounded to nearest even,
as the reference's wrapper reads any dtype as f32 and writes each output
back in its input's dtype (``:83-116``).  The dispatch takes all-f32 or
all-bf16 (p, g, m, v) and raises on any other mix; both take tensors
that start on a 16-byte boundary, as every allocation does.  ``1 - b1``
and ``1 - b2`` are rounded as the Pallas kernel forms them, in f32 from
the f32 betas (:53-57).  lr_t and wd_lr stay on the device, as the
reference passes them as data: a new rate never recompiles, never goes
through the host, and nothing synchronises.

Outputs: fresh tensors by default, so that ``Optimizer.functional_update``
stays pure as the reference's is; or, with ``out=``, tensors the caller
names, which may be the inputs themselves.  ``jit.TrainStep(donate=True)``
passes the parameters' and moments' own storage: the port's counterpart of
the reference's donation (jit/__init__.py:312-315), so that one copy of
the f32 parameters and their moments stays live.

Dispatch is by device: CPU tensors take :func:`fused_adam_reference`,
CUDA tensors the kernel, or a raise.
"""
from __future__ import annotations

import ctypes
import struct
import threading

import torch

__all__ = ["fused_adam", "fused_adam_reference", "launches",
           "launches_bf16", "one_minus"]

_MAX_TENSORS = 32          # tensors per launch (the kernel's table)

# kernel launches made by this process, f32 and bf16 (read by chip_smoke.py)
launches = 0
launches_bf16 = 0
_count_lock = threading.Lock()   # ranks simulated as threads launch too

_fns: dict = {}
_ENTRY = {torch.float32: "pt_fused_adam",
          torch.bfloat16: "pt_fused_adam_bf16"}


def _f32(x):
    return struct.unpack("f", struct.pack("f", x))[0]


def one_minus(beta):
    """``1 - beta`` as the Pallas kernel forms it: both in f32, the
    difference rounded to f32 (exact where beta lies in [0.5, 1])."""
    return _f32(1.0 - _f32(beta))


def _outputs(params, moments1, moments2, out):
    if out is not None:
        return out
    return ([torch.empty_like(p) for p in params],
            [torch.empty_like(m) for m in moments1],
            [torch.empty_like(v) for v in moments2])


def fused_adam_reference(params, grads, moments1, moments2, lr_t, wd_lr,
                         beta1, beta2, eps, out=None):
    """Plain PyTorch version: the reference's ``xla_reference`` (:119) once
    per tensor, every input widened to f32 and every output rounded (to
    nearest even) to its input's dtype.  ``lr_t`` is a (T,) f32 tensor,
    ``wd_lr`` a 0-d one.  Returns (new params, new moments1, new moments2)
    as lists, written into ``out`` when given."""
    po, mo, vo = _outputs(params, moments1, moments2, out)
    c1, c2 = one_minus(beta1), one_minus(beta2)
    for i, (p, g, m, v) in enumerate(zip(params, grads, moments1, moments2)):
        g, pf, m, v = g.float(), p.float(), m.float(), v.float()
        m2 = beta1 * m + c1 * g
        v2 = beta2 * v + c2 * g * g
        new_p = pf - lr_t[i] * m2 / (torch.sqrt(v2) + eps) - wd_lr * pf
        po[i].copy_(new_p)
        mo[i].copy_(m2)
        vo[i].copy_(v2)
    return po, mo, vo


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from paddle_tpu_torch.ops.cuda import _build
        fn = getattr(_build.load("fused_adam"), _ENTRY[dtype])
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _launch(params, grads, moments1, moments2, lr_t, wd_lr, beta1, beta2,
            eps, out=None):
    """The kernel on the card, one launch per 32 tensors of 16-byte
    aligned starts: the f32 instantiation or the bf16 one."""
    global launches, launches_bf16
    n = len(params)
    dev = params[0].device
    dtype = params[0].dtype
    if dtype not in _ENTRY:
        raise ValueError(f"fused_adam: parameters of {dtype}: the kernel "
                         "takes float32 or bfloat16 storage")
    for name, t in (("lr_t", lr_t), ("wd_lr", wd_lr)):
        if t.dtype != torch.float32 or t.device != dev or \
                not t.is_contiguous():
            raise ValueError(f"fused_adam: {name} must be a contiguous "
                             f"float32 tensor on {dev}")
    if tuple(lr_t.shape) != (n,) or wd_lr.numel() != 1:
        raise ValueError(f"fused_adam: lr_t must have shape ({n},) and wd_lr "
                         "one element")
    po, mo, vo = _outputs(params, moments1, moments2, out)
    groups = list(zip(params, grads, moments1, moments2, po, mo, vo))
    for i, ts in enumerate(groups):
        numel = ts[0].numel()
        for name, t in zip(("p", "g", "m", "v", "p_out", "m_out", "v_out"),
                           ts):
            if t.device != dev or t.dtype != dtype:
                raise ValueError(f"fused_adam: tensor {i} {name} must be "
                                 f"{dtype} on {dev} as the parameters are, "
                                 f"got {t.dtype} on {t.device}: the kernel "
                                 "takes all-f32 or all-bf16 (p, g, m, v)")
            if not t.is_contiguous() or t.numel() != numel or \
                    t.data_ptr() % 16:
                raise ValueError(f"fused_adam: tensor {i} {name} must be "
                                 "contiguous, of its parameter's size and "
                                 "16-byte aligned")
    consts = (float(beta1), one_minus(beta1), float(beta2),
              one_minus(beta2), float(eps))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(0, n, _MAX_TENSORS):
            grp = groups[s:s + _MAX_TENSORS]
            k = len(grp)
            ptrs = [(ctypes.c_void_p * k)(*(ts[j].data_ptr() for ts in grp))
                    for j in range(7)]
            numels = (ctypes.c_longlong * k)(*(ts[0].numel() for ts in grp))
            err = _kernel(dtype)(k, *ptrs, numels, lr_t.data_ptr() + 4 * s,
                                 wd_lr.data_ptr(), *consts, stream)
            if err != 0:
                raise RuntimeError(f"fused_adam: kernel launch failed with "
                                   f"cudaError {err}")
            with _count_lock:
                if dtype == torch.float32:
                    launches += 1
                else:
                    launches_bf16 += 1
    return po, mo, vo


def fused_adam(params, grads, moments1, moments2, lr_t, wd_lr, beta1, beta2,
               eps, out=None):
    """One Adam / AdamW step of every tensor in the lists, by device.

    ``params``, ``grads``, ``moments1``, ``moments2``: lists of tensors,
    all f32 or all bf16.  ``lr_t``: (T,) f32 tensor of bias-corrected
    rates; ``wd_lr``: 0-d f32 tensor; ``beta1``, ``beta2``, ``eps``:
    floats.  ``out``: optional
    (params, moments1, moments2) lists to write into (they may be the
    inputs).  Returns the three lists of new values."""
    if not params:
        return [], [], []
    dtype = params[0].dtype
    mixed = sorted({str(t.dtype) for ts in (params, grads, moments1, moments2)
                    for t in ts} - {str(dtype)})
    if dtype not in _ENTRY or mixed:
        raise ValueError(f"fused_adam: (p, g, m, v) must be all float32 or "
                         f"all bfloat16, got parameters of {dtype} beside "
                         f"{mixed}")
    dev = params[0].device
    if dev.type == "cpu":
        return fused_adam_reference(params, grads, moments1, moments2, lr_t,
                                    wd_lr, beta1, beta2, eps, out)
    if dev.type == "cuda":
        return _launch(params, grads, moments1, moments2, lr_t, wd_lr, beta1,
                       beta2, eps, out)
    raise ValueError(f"fused_adam: unsupported device {dev}")
