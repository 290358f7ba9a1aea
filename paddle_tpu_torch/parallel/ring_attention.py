"""Ring attention: sequence parallelism over a mesh axis (port of
paddle_tpu/parallel/ring_attention.py :35-133), on the flash kernels.

Each rank of the ``sp`` group holds one contiguous chunk of the sequence
of q, k and v, (B, S/n, H, D), rank j positions [j S/n, (j + 1) S/n).  At
ring step t rank r holds the k / v chunk of ``src = (r - t) mod n`` and
attends its q chunk to it; k and v then move one hop round the ring
(``ring_shift``).  Where the reference's ``_ring_body`` (``:75-113``)
accumulates block einsums with a running max, the port runs each chunk
pair as one call of the flash kernels and merges by lse:

- forward: ``src == r`` is the causal diagonal, one causal launch of
  kernel #1 (``sq == sk``, so the end-aligned rule is the usual one);
  ``src < r`` one non-causal launch; ``src > r`` lies wholly above the
  diagonal under ``causal=True`` and is skipped (the reference computes it
  and multiplies it by 0).  The chunks' outputs merge in f32, ``lse =
  logaddexp`` over them and ``out = sum exp(lse_j - lse) out_j``, cast to
  the input dtype once;
- backward (one ``torch.autograd.Function``): ``delta = rowsum(do * o)``
  of the final merged output, then the ring walked again, kernel #2 for
  dq and #3 for dk / dv on each live chunk with the global lse and delta.
  The dk / dv partials travel with their chunk and reach its owner after
  n hops; a skipped chunk launches nothing.

So under ``causal=True`` rank r launches #1 r + 1 times a forward, and #2
and #3 r + 1 times each a backward: n (n + 1) / 2 over the ring.

A chunk takes the kernels where ``flash_attention.supported`` admits its
(S/n, D) (head dim 64 or 128, S/n >= 128, f32 or bf16): the CUDA kernel
on a CUDA tensor, its plain version (``flash_attention_reference``,
``flash_attention_bwd_reference``) on a CPU tensor.  Any other chunk takes
the dense step, the same plain arithmetic on any device, which also
returns lse, merged the same way.  This is a rule, not a caught error: a
CUDA chunk the rule admits launches the kernel or raises.  ``chunk_calls``
counts the chunk steps of each route (plain or kernel), for the tests.

On ranks simulated as threads on the card (``LoopbackWorld``) the output
crosses to the host so the backward, whose ring is a collective, runs on
the rank's own thread (``parallel/tp.py``, the host hop).
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import torch

from paddle_tpu_torch.ops.cuda import flash_attention as _fa
from paddle_tpu_torch.parallel import tp
from paddle_tpu_torch.parallel.mesh import get_mesh

__all__ = ["ring_attention", "ring_attention_local", "ring_attention_manual",
           "chunk_calls"]

# chunk steps by route: the flash route's forward, dq and dk/dv (the
# kernels on the card, their plain versions on the CPU) and the dense
# route's forward and backward
chunk_calls = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
               "dense_fwd": 0, "dense_bwd": 0}
_lock = threading.Lock()


def _tick(key: str):
    with _lock:
        chunk_calls[key] += 1


def _flash_route(q: torch.Tensor) -> bool:
    return _fa.supported(tuple(q.shape), tuple(q.shape), causal=True,
                         dtype=q.dtype)


def _chunk_fwd(qt, kt, vt, scale, causal, flash):
    """(out in the input dtype, lse f32) of one folded chunk pair."""
    if flash and qt.is_cuda:
        _tick("flash_fwd")
        return _fa._launch(qt, kt, vt, scale, causal)
    _tick("flash_fwd" if flash else "dense_fwd")
    return _fa.flash_attention_reference(qt, kt, vt, scale, causal)


def _chunk_bwd(qt, kt, vt, ot, lse, dot, delta, scale, causal, flash):
    """(dq, dk, dv) of one folded chunk pair from the global lse and
    delta (``ot`` is the merged output delta was taken from; the plain
    version takes delta from it)."""
    if flash and qt.is_cuda:
        _tick("flash_dq")
        _tick("flash_dkv")
        dq = _fa._launch_dq(qt, kt, vt, dot, lse, delta, scale, causal)
        dk, dv = _fa._launch_dkv(qt, kt, vt, dot, lse, delta, scale, causal)
        return dq, dk, dv
    if flash:
        _tick("flash_dq")
        _tick("flash_dkv")
    else:
        _tick("dense_bwd")
    return _fa.flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot, scale,
                                             causal)


def _merge(outs, lses, dtype):
    """The chunks' outputs merged by their lse in f32, cast once."""
    if len(outs) == 1:
        return outs[0], lses[0]
    lse = lses[0]
    for l in lses[1:]:
        lse = torch.logaddexp(lse, l)
    live = torch.isfinite(lse)
    acc = None
    for o, l in zip(outs, lses):
        w = torch.where(live, torch.exp(l - torch.where(live, lse, 0.0)),
                        0.0)
        term = w[..., None] * o.float()
        acc = term if acc is None else acc + term
    return acc.to(dtype), lse


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, hop):
        b, s, h, _ = q.shape
        n, r = group.size, group.rank
        flash = _flash_route(q)
        qt, kt, vt = (_fa._fold(t.detach()) for t in (q, k, v))
        outs, lses, kc, vc = [], [], kt, vt
        for t in range(n):
            src = (r - t) % n
            if not causal or src <= r:
                o, l = _chunk_fwd(qt, kc, vc, scale, causal and src == r,
                                  flash)
                outs.append(o)
                lses.append(l)
            if t < n - 1:
                kc, vc = group.ring_shift([kc, vc])
        out, lse = _merge(outs, lses, q.dtype)
        ctx.save_for_backward(qt, kt, vt, out, lse.contiguous())
        ctx.group, ctx.causal, ctx.scale, ctx.flash = group, causal, scale, \
            flash
        ctx.hop, ctx.device, ctx.bh = hop, q.device, (b, h)
        y = _fa._unfold(out, b, h)
        return tp._out(y, hop) if hop else y

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, ot, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, r = group.size, group.rank
        dot = _fa._fold(tp._back(dout, ctx.device, ctx.hop))
        delta = _fa._delta(dot, ot)
        dq = torch.zeros(qt.shape, dtype=torch.float32, device=qt.device)
        dkc = torch.zeros(kt.shape, dtype=torch.float32, device=qt.device)
        dvc = torch.zeros_like(dkc)
        kc, vc = kt, vt
        for t in range(n):
            src = (r - t) % n
            if not causal or src <= r:
                dq_j, dk_j, dv_j = _chunk_bwd(qt, kc, vc, ot, lse, dot, delta,
                                              scale, causal and src == r,
                                              ctx.flash)
                dq += dq_j.float()
                dkc += dk_j.float()
                dvc += dv_j.float()
            if t < n - 1:
                kc, vc, dkc, dvc = group.ring_shift([kc, vc, dkc, dvc])
            else:
                dkc, dvc = group.ring_shift([dkc, dvc])
        b, h = ctx.bh
        dt = qt.dtype
        return (_fa._unfold(dq.to(dt), b, h), _fa._unfold(dkc.to(dt), b, h),
                _fa._unfold(dvc.to(dt), b, h), None, None, None, None)


def _ring(q, k, v, causal, scale, group):
    """The ring over ``group``."""
    hop = group.size > 1 and tp.needs_hop(q, k, v)
    y = _Ring.apply(q, k, v, group, bool(causal), float(scale), hop)
    return y.to(q.device) if hop else y


class _OneGroup:
    """A group of one rank: the n <= 1 path, one local attention."""
    rank, size = 0, 1

    def ring_shift(self, bufs):
        return list(bufs)


def ring_attention(q, k, v, causal: bool = True,
                   scale: Optional[float] = None, mesh=None,
                   sp_axis: str = "sp", data_axes=("dp",)):
    """Attention of this rank's (B, S/n, H, D) sequence chunks of q, k, v
    over the ``sp_axis`` ring of ``mesh`` (the active one by default); with
    n <= 1 one local attention (reference ``:43-45``).  ``data_axes`` is
    accepted for the reference's signature: each rank already holds its
    batch rows."""
    mesh = mesh or get_mesh()
    n = mesh.shape.get(sp_axis, 1)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = mesh.axis_group(sp_axis) if n > 1 else _OneGroup()
    return _ring(q, k, v, causal, scale, group)


def ring_attention_manual(q, k, v, causal: bool = True, scale=None,
                          sp_axis: str = "sp", n=None, manual_axes=None):
    """The ring on this rank's chunks over the active mesh's ``sp_axis``
    (reference ``:59``, for a caller already inside a manual region; in the
    port every region is manual).  ``n``, when given, must be the axis
    size; ``manual_axes`` is accepted for the reference's signature."""
    mesh = get_mesh()
    size = mesh.shape.get(sp_axis, 1)
    if n is not None and n != size:
        raise ValueError(f"n={n} is not the mesh's {sp_axis} size {size}")
    return ring_attention(q, k, v, causal, scale, mesh, sp_axis)


def ring_attention_local(q, k, v, causal: bool = True, scale=None):
    """Single-device dense attention in f32 (reference ``:128``, what the
    tests hold the ring to), cast to q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqkh", q.float() * scale, k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep[None, :, :, None], float("-inf"))
    p = torch.softmax(s, dim=2)
    return torch.einsum("bqkh,bkhd->bqhd", p, v.float()).to(q.dtype)
