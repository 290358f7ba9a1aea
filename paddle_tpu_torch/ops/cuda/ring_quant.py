"""Per-row wire quantizer, the codec of the quantized collectives (port of
paddle_tpu/ops/pallas/ring_quant.py).

For each row of an (R, D) f32 tensor:

    scale = max|row| / qmax          (qmax 127 for int8, 7 for int4;
                                      a scale that is not > 0 becomes 1)
    q     = clip(rint(x / scale), -qmax, qmax)   as int8

with IEEE division and round-half-to-even, bitwise the codec of
``distributed/wire.py`` (the reference pins its Pallas kernel to the same
codec, ``ring_quant.py:21-24``).  int4 packs two values per byte, low
nibble first, with a zero pad nibble for an odd D.  Returns (q, scale):
q int8 (R, D) or uint8 (R, ceil(D / 2)), scale f32 (R,).

The kernel is ``csrc/ring_quant.cu`` (hand-written CUDA for sm_90a), which
replaces the Pallas ``_rowquant_kernel`` and fuses the nibble pack that the
reference leaves to a jnp epilogue.  Its rule is only ``wire`` in {int8,
int4}: any D >= 1 and any row count.  The reference's rule that D be a
multiple of 128 is the TPU's lane layout and is not the card's.  The cast
wires (f32, bf16, f16) never take it.

Dispatch is by device: a CPU tensor takes :func:`ring_quant_rows_reference`,
a CUDA tensor the kernel, or a raise.  ``launches`` counts every launch of
the process; :func:`thread_launches` those of the calling thread, so ranks
simulated as threads each read their own count.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from paddle_tpu_torch.distributed.wire import (COLLECTIVE_WIRE_DTYPES,
                                               normalize_wire,
                                               pack_nibbles_torch)

__all__ = ["ring_quant_rows", "ring_quant_rows_reference", "thread_launches",
           "launches"]

_QMAX = {"int8": 127.0, "int4": 7.0}

# kernel launches made by this process (read by chip_smoke.py)
launches = 0
_count_lock = threading.Lock()
_local = threading.local()

_fn = None


def thread_launches() -> int:
    """Kernel launches made by the calling thread."""
    return getattr(_local, "launches", 0)


def _check_wire(wire: str) -> str:
    wire = normalize_wire(wire, known=COLLECTIVE_WIRE_DTYPES)
    if wire not in _QMAX:
        raise ValueError(f"ring_quant: the row quantizer encodes int8 and "
                         f"int4, got the cast wire {wire!r}")
    return wire


def ring_quant_rows_reference(rows: torch.Tensor, wire: str):
    """Plain PyTorch codec on (R, D) rows: (q, scale) as the module
    docstring gives them.  Both divisions take a tensor divisor on the
    rows' device: PyTorch's CUDA division by a Python or CPU scalar
    multiplies by its reciprocal, which is not IEEE division."""
    wire = _check_wire(wire)
    r = rows.to(torch.float32)
    qmax = torch.full((), _QMAX[wire], dtype=torch.float32, device=r.device)
    scale = r.abs().amax(-1) / qmax
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(r / scale[..., None]), -qmax, qmax).to(
        torch.int8)
    return (pack_nibbles_torch(q) if wire == "int4" else q), scale


def _kernel():
    global _fn
    if _fn is None:
        from paddle_tpu_torch.ops.cuda import _build
        fn = _build.load("ring_quant").pt_ring_quant_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(rows: torch.Tensor, wire: str):
    """The kernel on the card: (q, scale) of (R, D) f32 rows."""
    global launches
    wire = _check_wire(wire)
    if rows.device.type != "cuda" or rows.dtype != torch.float32 or \
            rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"ring_quant: the kernel takes contiguous (R, D) "
                         f"float32 rows on the card, got {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    r, d = rows.shape
    if d < 1:
        raise ValueError("ring_quant: rows must have at least one column")
    int4 = wire == "int4"
    q = torch.empty((r, (d + 1) // 2 if int4 else d),
                    dtype=torch.uint8 if int4 else torch.int8,
                    device=rows.device)
    scale = torch.empty(r, dtype=torch.float32, device=rows.device)
    if r == 0:
        return q, scale
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(rows.data_ptr(), q.data_ptr(), scale.data_ptr(), r,
                        d, int(int4), stream)
    if err != 0:
        raise RuntimeError(f"ring_quant: kernel launch failed with "
                           f"cudaError {err}")
    with _count_lock:
        launches += 1
    _local.launches = thread_launches() + 1
    return q, scale


def ring_quant_rows(rows: torch.Tensor, wire: str):
    """(q, scale) of (R, D) f32 rows for the int8 or int4 wire, by device:
    the plain codec on a CPU tensor, kernel #9 on a CUDA tensor."""
    if rows.device.type == "cpu":
        return ring_quant_rows_reference(rows, wire)
    if rows.device.type == "cuda":
        return _launch(rows.contiguous(), wire)
    raise ValueError(f"ring_quant: unsupported device {rows.device}")
