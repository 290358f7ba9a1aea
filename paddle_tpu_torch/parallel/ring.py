"""Quantized ring collectives: the codec between neighbour hops (port of
paddle_tpu/parallel/ring.py).

Two primitives over a pure dp mesh, both speaking ``distributed/wire.py``'s
row codec (``chunk``-wide rows, one scale a row):

- :func:`ring_reduce_scatter`: the partial-sum ring.  Each of the n - 1
  hops ships one encoded partial to rank + 1, which decodes it, adds its
  own block in f32 and re-encodes it for the next hop.
- :func:`ring_all_gather`: the relay ring.  The local shard is encoded
  once and forwarded hop by hop; every rank, the source included, decodes
  the same bytes, so the gathered vectors are bitwise equal on every rank.

A hop is ``mesh.group.ring_shift``: point-to-point send and receive
(``torch.distributed.batch_isend_irecv``), the reference's ``ppermute`` by
+1, with its seat arithmetic (``:99-113``, ``:141-156``).  At n = 1 both
return at once, before any encode (``:84-85``, ``:130-131``).  The f32
wire keeps the plain collectives, in the exact order of
``parallel/zero.py``: an all-to-all then an ascending sum for the
reduce-scatter, an all-gather for the all-gather.  The int8 / int4 encode
of a CUDA tensor runs kernel #9 (``ops/cuda/ring_quant.py``).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed.wire import (COLLECTIVE_WIRE_DTYPES,
                                               dequantize_rows_torch,
                                               normalize_wire,
                                               quantize_rows_torch)
from paddle_tpu_torch.parallel.mesh import ordered_sum

__all__ = ["ring_reduce_scatter", "ring_all_gather"]


def _blocks(flat: torch.Tensor, chunk: int) -> torch.Tensor:
    if flat.shape[0] % chunk:
        raise ValueError(
            f"ring payload length {flat.shape[0]} not divisible by "
            f"chunk {chunk}: pad with build_shard_specs first")
    return flat.reshape(-1, chunk)


def ring_reduce_scatter(gflat: torch.Tensor, mesh, *, chunk: int = 256,
                        wire: str = "f32") -> torch.Tensor:
    """(n * shard_len,) local vector -> (shard_len,) SUM over the ranks of
    the chunk this rank owns (chunk i on rank i).  The caller divides by n
    for a mean."""
    wire = normalize_wire(wire, known=COLLECTIVE_WIRE_DTYPES)
    n, idx, group = mesh.shape["dp"], mesh.rank, mesh.group
    g = gflat.to(torch.float32)
    if n == 1:
        return g
    if wire == "f32":
        return ordered_sum(group.all_to_all(g.reshape(n, -1)))
    blocks = _blocks(g, chunk).reshape(n, -1, chunk)
    # hop 0 ships the local block of the chunk one seat behind: after n - 1
    # hops the partial of this rank's own chunk arrives summed
    q = quantize_rows_torch(blocks[(idx - 1) % n], wire)
    for t in range(n - 1):
        recv = group.ring_shift(q)
        # decode the partial in flight, add the local block in f32 and
        # re-encode it: the last sum is decoded from its encoding too
        part = dequantize_rows_torch(recv, wire) + blocks[(idx - t - 2) % n]
        q = quantize_rows_torch(part, wire)
    return dequantize_rows_torch(q, wire).reshape(-1)


def ring_all_gather(shard: torch.Tensor, mesh, *, chunk: int = 256,
                    wire: str = "f32") -> torch.Tensor:
    """(shard_len,) owned chunk -> (n * shard_len,) full vector, the same
    bits on every rank."""
    wire = normalize_wire(wire, known=COLLECTIVE_WIRE_DTYPES)
    n, idx, group = mesh.shape["dp"], mesh.rank, mesh.group
    s = shard.to(torch.float32)
    if n == 1:
        return s
    if wire == "f32":
        return group.all_gather(s).reshape(-1)
    rows = _blocks(s, chunk)
    bufs = quantize_rows_torch(rows, wire)             # encode once
    out = torch.empty((n,) + tuple(rows.shape), dtype=torch.float32,
                      device=s.device)
    out[idx] = dequantize_rows_torch(bufs, wire)        # the source's too
    for t in range(n - 1):
        bufs = group.ring_shift(bufs)
        out[(idx - t - 1) % n] = dequantize_rows_torch(bufs, wire)
    return out.reshape(-1)
