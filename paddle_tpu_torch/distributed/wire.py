"""Wire quantization of the data-parallel collectives (port of
paddle_tpu/distributed/wire.py).

One encode / decode discipline for every byte stream a collective ships:
exact f32, bf16 or f16 casts, int8 with one symmetric f32 scale per row
(``max|row| / 127``), and the packed int4 codec (``max|row| / 7``, values
clipped to [-7, 7], two nibbles per byte, low nibble first, a zero pad
nibble for an odd width).  A row whose scale is not > 0 (all zeros, or a
NaN in it) gets scale 1, so it decodes to exact zeros.  Rounding is half to
even.

Two mirrored forms, as in the reference:

- :func:`quantize_rows` / :func:`dequantize_rows` — numpy, the parameter
  server's wire (verbatim semantics);
- :func:`quantize_rows_torch` / :func:`dequantize_rows_torch` — the
  reference's traced pair, on torch tensors.  The int8 / int4 encode goes
  through ``ops/cuda/ring_quant.py``: the hand-written kernel on a CUDA
  tensor, its plain PyTorch codec on a CPU tensor.  Both are bitwise equal
  to the numpy pair.

This module imports numpy and torch only; the reference's copy is not
imported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["WIRE_DTYPES", "COLLECTIVE_WIRE_DTYPES", "normalize_wire",
           "quantize_rows", "dequantize_rows", "quantize_rows_torch",
           "dequantize_rows_torch", "wire_nbytes"]

#: the parameter-server negotiated set (grow-only)
WIRE_DTYPES = ("f32", "bf16", "int8", "int4")

#: the collective set: adds f16, which never crosses the PS wire
COLLECTIVE_WIRE_DTYPES = ("f32", "bf16", "f16", "int8", "int4")

_WIRE_ALIASES = {"f32": "f32", "float32": "f32", "fp32": "f32",
                 "bf16": "bf16", "bfloat16": "bf16",
                 "f16": "f16", "float16": "f16", "fp16": "f16",
                 "int8": "int8", "s8": "int8",
                 "int4": "int4", "s4": "int4", "i4": "int4"}


def normalize_wire(name, known=WIRE_DTYPES) -> str:
    """Canonical wire-dtype name (reference ``:63``); raises on anything
    outside ``known``, so a typo fails loudly instead of shipping f32."""
    w = _WIRE_ALIASES.get(str(name).lower())
    if w is None or w not in known:
        kind = "PS wire" if tuple(known) == WIRE_DTYPES else "wire"
        raise ValueError(f"unknown {kind} dtype {name!r} "
                         f"(known: {sorted(known)})")
    return w


# ---------------------------------------------------------------------------
# nibble packing (reference :81-104)
# ---------------------------------------------------------------------------

def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """Pack int4 values (int8 carrier, [-7, 7]) two per byte along the
    trailing axis: low nibble first, an odd width padded with a zero
    nibble, two's complement (-7 -> 0x9)."""
    if q.shape[-1] % 2:
        q = np.pad(q, [(0, 0)] * (q.ndim - 1) + [(0, 1)])
    u = q.astype(np.uint8) & 0xF
    return u[..., 0::2] | (u[..., 1::2] << 4)


def _unpack_nibbles(packed: np.ndarray, cols: int) -> np.ndarray:
    """Inverse of :func:`_pack_nibbles`, trimmed to ``cols`` values."""
    lo = ((packed & 0xF).astype(np.int8) ^ 8) - 8
    hi = ((packed >> 4).astype(np.int8) ^ 8) - 8
    q = np.stack([lo, hi], axis=-1).reshape(packed.shape[:-1]
                                            + (2 * packed.shape[-1],))
    return q[..., :cols]


def pack_nibbles_torch(q: torch.Tensor) -> torch.Tensor:
    """:func:`_pack_nibbles` on an int8 tensor: (..., D) -> uint8
    (..., ceil(D / 2))."""
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    u = q.to(torch.uint8) & 0xF
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_nibbles_torch(packed: torch.Tensor, cols: int) -> torch.Tensor:
    """:func:`_unpack_nibbles` on a uint8 tensor: int8 (..., cols)."""
    lo = ((packed & 0xF).to(torch.int8) ^ 8) - 8
    hi = ((packed >> 4).to(torch.int8) ^ 8) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))
    return q[..., :cols]


# ---------------------------------------------------------------------------
# numpy pair (reference :116-155)
# ---------------------------------------------------------------------------

def _row_scale_np(r: np.ndarray, qmax: float) -> np.ndarray:
    scale = np.max(np.abs(r), axis=-1) / np.float32(qmax)
    return np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)


def quantize_rows(rows, wire: str):
    """Encode f32 rows (N, D): ``[rows]`` for f32, the bf16 cast for bf16
    (a torch tensor: numpy has no bf16), ``[q_int8, scale_f32]`` for int8
    and ``[packed_uint8, scale_f32]`` for int4.  Validates against the
    PS-negotiated set."""
    r = np.asarray(rows, np.float32)
    wire = normalize_wire(wire)
    if wire == "f32":
        return [r]
    if wire == "bf16":
        return [torch.from_numpy(r).to(torch.bfloat16)]
    qmax = 7.0 if wire == "int4" else 127.0
    scale = _row_scale_np(r, qmax)
    q = np.clip(np.rint(r / scale[..., None]), -qmax, qmax).astype(np.int8)
    return [_pack_nibbles(q) if wire == "int4" else q, scale]


def dequantize_rows(bufs, wire: str, cols: int = 0) -> np.ndarray:
    """Decode :func:`quantize_rows` buffers back to f32 rows; ``cols`` is
    the logical width of an int4 payload (0: twice the packed width)."""
    wire = normalize_wire(wire)
    if wire in ("int8", "int4"):
        q = np.asarray(bufs[0])
        if wire == "int4":
            q = _unpack_nibbles(q.astype(np.uint8), cols or 2 * q.shape[-1])
        return q.astype(np.float32) * np.asarray(bufs[1],
                                                 np.float32)[..., None]
    if wire == "bf16":
        return torch.as_tensor(bufs[0]).float().numpy()
    return np.asarray(bufs[0], np.float32)


# ---------------------------------------------------------------------------
# torch pair (the reference's traced pair, :162-203)
# ---------------------------------------------------------------------------

def quantize_rows_torch(rows: torch.Tensor, wire: str) -> tuple:
    """Encode (..., D) rows for a collective: ``(rows f32,)`` for f32, the
    cast for bf16 / f16, ``(q int8, scale f32)`` for int8 and ``(packed
    uint8, scale f32)`` for int4, one scale per trailing row.  The int8 /
    int4 encode runs kernel #9 on a CUDA tensor, the plain codec on a CPU
    tensor (``ops/cuda/ring_quant.py``)."""
    wire = normalize_wire(wire, known=COLLECTIVE_WIRE_DTYPES)
    r = rows.to(torch.float32)
    if wire == "f32":
        return (r,)
    if wire in ("bf16", "f16"):
        return (r.to(torch.bfloat16 if wire == "bf16" else torch.float16),)
    from paddle_tpu_torch.ops.cuda import ring_quant
    lead, d = r.shape[:-1], r.shape[-1]
    q, scale = ring_quant.ring_quant_rows(r.reshape(-1, d), wire)
    return q.reshape(lead + q.shape[-1:]), scale.reshape(lead)


def dequantize_rows_torch(bufs, wire: str, cols: int = 0) -> torch.Tensor:
    """Decode :func:`quantize_rows_torch` buffers back to f32 rows; ``cols``
    is the logical width of an int4 payload (0: twice the packed width)."""
    wire = normalize_wire(wire, known=COLLECTIVE_WIRE_DTYPES)
    if wire in ("int8", "int4"):
        q, scale = bufs[0], bufs[1]
        if wire == "int4":
            q = unpack_nibbles_torch(q, cols or 2 * q.shape[-1])
        return q.to(torch.float32) * scale[..., None]
    return bufs[0].to(torch.float32)


# ---------------------------------------------------------------------------
# byte accounting (reference :214)
# ---------------------------------------------------------------------------

_ELEM_BYTES = {"f32": 4.0, "bf16": 2.0, "f16": 2.0, "int8": 1.0,
               "int4": 0.5}


def wire_nbytes(n_elems: int, wire: str, row: int = 0) -> int:
    """Bytes on the wire for ``n_elems`` encoded values.  For int8 and int4
    ``row`` is the values per f32 scale (0: a single row); int4 rows round
    up to whole bytes."""
    wire = normalize_wire(wire, known=COLLECTIVE_WIRE_DTYPES)
    if wire == "int4":
        rows = math.ceil(n_elems / row) if row else 1
        per_row = row if row else n_elems
        payload = rows * (math.ceil(per_row / 2) + 4.0)
    else:
        payload = _ELEM_BYTES[wire] * n_elems
        if wire == "int8":
            rows = math.ceil(n_elems / row) if row else 1
            payload += 4.0 * rows
    return int(payload)
