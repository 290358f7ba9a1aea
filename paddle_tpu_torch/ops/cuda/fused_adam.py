"""Fused Adam / AdamW update over many tensors (port of
paddle_tpu/ops/pallas/fused_adam.py).

One pass over (p, g, m, v) of every parameter gives (p', m', v') in f32:

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g g
    p' = p - lr_t m' / (sqrt(v') + eps) - wd_lr p

with ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)`` per tensor (its own beta
pows) and ``wd_lr = lr * coeff`` for AdamW's decoupled decay (0 for Adam).
The kernel is ``csrc/fused_adam.cu`` (hand-written CUDA for sm_90a), which
replaces the Pallas ``_adam_kernel``: where the reference launches it once
per tensor, one launch here updates up to 32 tensors (a multi-tensor
apply).  lr_t and wd_lr stay on the device, as the reference passes them as
data: a new rate never recompiles, never goes through the host, and
nothing synchronises.

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
import threading

import torch

__all__ = ["fused_adam", "fused_adam_reference", "launches"]

_MAX_TENSORS = 32          # tensors per launch (the kernel's table)

# kernel launches made by this process (read by chip_smoke.py)
launches = 0
_count_lock = threading.Lock()   # ranks simulated as threads launch too

_fn = None


def _outputs(params, moments1, moments2, out):
    if out is not None:
        return out
    return ([torch.empty_like(p) for p in params],
            [torch.empty_like(m) for m in moments1],
            [torch.empty_like(v) for v in moments2])


def fused_adam_reference(params, grads, moments1, moments2, lr_t, wd_lr,
                         beta1, beta2, eps, out=None):
    """Plain PyTorch version: the reference's ``xla_reference`` (:119) once
    per tensor.  ``lr_t`` is a (T,) f32 tensor, ``wd_lr`` a 0-d one.
    Returns (new params, new moments1, new moments2) as lists, written into
    ``out`` when given."""
    po, mo, vo = _outputs(params, moments1, moments2, out)
    for i, (p, g, m, v) in enumerate(zip(params, grads, moments1, moments2)):
        g = g.float()
        pf = p.float()
        m2 = beta1 * m + (1 - beta1) * g
        v2 = beta2 * v + (1 - beta2) * g * g
        new_p = pf - lr_t[i] * m2 / (torch.sqrt(v2) + eps) - wd_lr * pf
        po[i].copy_(new_p)
        mo[i].copy_(m2)
        vo[i].copy_(v2)
    return po, mo, vo


def _kernel():
    global _fn
    if _fn is None:
        from paddle_tpu_torch.ops.cuda import _build
        fn = _build.load("fused_adam").pt_fused_adam
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(params, grads, moments1, moments2, lr_t, wd_lr, beta1, beta2,
            eps, out=None):
    """The kernel on the card, one launch per 32 tensors."""
    global launches
    n = len(params)
    dev = params[0].device
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
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"fused_adam: tensor {i} {name} must be "
                                 f"float32 on {dev}, got {t.dtype} on "
                                 f"{t.device}")
            if not t.is_contiguous() or t.data_ptr() % 16 or \
                    t.numel() != numel:
                raise ValueError(f"fused_adam: tensor {i} {name} must be "
                                 "contiguous, 16-byte aligned and of its "
                                 "parameter's size")
    consts = (float(beta1), float(1 - beta1), float(beta2),
              float(1 - beta2), float(eps))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(0, n, _MAX_TENSORS):
            grp = groups[s:s + _MAX_TENSORS]
            k = len(grp)
            ptrs = [(ctypes.c_void_p * k)(*(ts[j].data_ptr() for ts in grp))
                    for j in range(7)]
            numels = (ctypes.c_longlong * k)(*(ts[0].numel() for ts in grp))
            err = _kernel()(k, *ptrs, numels, lr_t.data_ptr() + 4 * s,
                            wd_lr.data_ptr(), *consts, stream)
            if err != 0:
                raise RuntimeError(f"fused_adam: kernel launch failed with "
                                   f"cudaError {err}")
            with _count_lock:
                launches += 1
    return po, mo, vo


def fused_adam(params, grads, moments1, moments2, lr_t, wd_lr, beta1, beta2,
               eps, out=None):
    """One Adam / AdamW step of every tensor in the lists, by device.

    ``lr_t``: (T,) f32 tensor of bias-corrected rates; ``wd_lr``: 0-d f32
    tensor; ``beta1``, ``beta2``, ``eps``: floats.  ``out``: optional
    (params, moments1, moments2) lists to write into (they may be the
    inputs).  Returns the three lists of new values."""
    if not params:
        return [], [], []
    dev = params[0].device
    if dev.type == "cpu":
        return fused_adam_reference(params, grads, moments1, moments2, lr_t,
                                    wd_lr, beta1, beta2, eps, out)
    if dev.type == "cuda":
        return _launch(params, grads, moments1, moments2, lr_t, wd_lr, beta1,
                       beta2, eps, out)
    raise ValueError(f"fused_adam: unsupported device {dev}")
