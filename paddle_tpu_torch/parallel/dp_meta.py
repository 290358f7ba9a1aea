"""The replicated data-parallel step with a compressed gradient all-reduce
(port of paddle_tpu/parallel/dp_meta.py ``CompressedAllReduceTrainStep``
:236; its ``_loss_closure`` :53 is ``jit.loss_closure``).

Each rank takes its slice of the global batch (the reference's
``shard_map`` with ``P("dp")`` inputs), computes its loss and gradients,
and every gradient is averaged over the ranks on the wire the step names;
then each rank applies the same full update, so the parameters stay
replicated.

- ``f32``: the exact leg.  An all-gather, then the ascending sum over the
  ranks (``parallel.ring.ordered_sum``) divided by dp: the reduction of
  ``parallel/zero.py``'s f32 reduce-scatter, value for value, so the two
  steps agree bitwise whatever the backend (gloo's and NCCL's own
  all-reduce each choose their order).
- ``bf16`` / ``f16``: the gradients cross in the wire dtype, are added in
  f32 and rounded back to it, then decoded: the reference's CPU promotion
  of sub-f32 reduces (``:323-328``), here on every backend.
- ``ring=True`` (or ``FLAGS_zero_ring_collectives``): the quantized ring
  (``parallel/ring.py``) reduce-scatter then all-gather of each padded
  flat gradient, which admits int8 and int4 too.

The loss is the mean of the ranks' losses.  Floating buffers
(BatchNorm's running statistics, which each rank updates from its own
slice of the batch) are averaged over the ranks after the step, in f32
and cast back (:338-346), never on the gradients' wire.  ``recompute=True``
makes the rank's whole loss one recompute region (reference :80-81), as in
``jit.TrainStep``.  Not ported, and raising: a ``grad_clip``, which the
reference's step ignores.  LocalSGD and DGC are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from paddle_tpu_torch.distributed.wire import (COLLECTIVE_WIRE_DTYPES,
                                               dequantize_rows_torch,
                                               normalize_wire,
                                               quantize_rows_torch)
from paddle_tpu_torch.jit import loss_and_grads, loss_closure
from paddle_tpu_torch.parallel.mesh import _require_pure_dp, get_mesh
from paddle_tpu_torch.parallel.ring import (ordered_sum, ring_all_gather,
                                            ring_reduce_scatter)

__all__ = ["CompressedAllReduceTrainStep"]


def _amp_dtype(amp_dtype):
    return (torch.bfloat16 if str(amp_dtype) in (
        "bfloat16", "bf16", "torch.bfloat16") else torch.float16)


def local_batch(inputs, mesh, device):
    """This rank's slice of each global-batch input (the leading axis cut
    into dp equal parts), on ``device``."""
    n, idx = mesh.shape["dp"], mesh.rank
    out = []
    for i in inputs:
        t = torch.as_tensor(i)
        if t.shape[0] % n:
            raise ValueError(f"global batch {t.shape[0]} is not divisible "
                             f"by dp={n}")
        out.append(t.reshape((n, -1) + tuple(t.shape[1:]))[idx].to(device))
    return out


def mean_over_ranks(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ascending-order mean of a tensor over the ranks (the reference's
    ``pmean``)."""
    n = mesh.shape["dp"]
    return ordered_sum(mesh.group.all_gather(x)) / n


def average_buffers(model, mesh):
    """Every floating buffer of ``model`` replaced by its mean over the
    ranks, taken in f32 and cast back (the reference's ``pmean`` of the
    new buffers); nothing to do at world size 1."""
    if mesh.shape.get("dp", 1) == 1:
        return
    for b in model.buffers():
        if b.is_floating_point():
            b.copy_(mean_over_ranks(b.float(), mesh).to(b.dtype))


class CompressedAllReduceTrainStep:
    """DP train step whose gradient all-reduce runs in ``compress_dtype``
    (reference ``:236``): construct with ``(model, loss_fn, optimizer)``,
    call with the global batch, read back the f32 loss."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 compress_dtype="float16", amp_level=None,
                 amp_dtype="bfloat16", recompute: bool = False,
                 ring: Optional[bool] = None, chunk: int = 256):
        from paddle_tpu_torch.framework.flags import flag
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh or get_mesh()
        _require_pure_dp(self.mesh, "compressed-allreduce")
        self.dp = self.mesh.shape.get("dp", 1)
        self.ring = bool(flag("zero_ring_collectives")
                         if ring is None else ring)
        if int(chunk) < 1:
            raise ValueError("chunk must be >= 1")
        self.chunk = int(chunk)
        known = COLLECTIVE_WIRE_DTYPES if self.ring \
            else ("f32", "f16", "bf16")
        self.wire = normalize_wire(compress_dtype, known=known)
        if getattr(optimizer, "_grad_clip", None) is not None:
            raise NotImplementedError(
                "CompressedAllReduceTrainStep with a grad_clip: the "
                "reference's step ignores the clip, the port does not "
                "train without it")
        self.amp_level = amp_level
        self.amp_dtype = _amp_dtype(amp_dtype)
        self._loss_from = loss_closure(model, loss_fn, amp_level,
                                       self.amp_dtype, recompute)
        self._opt_states = None

    def _reduce(self, g: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of one gradient, on the wire."""
        if self.ring:
            flat = g.reshape(-1).to(torch.float32)
            pad = -flat.shape[0] % (self.dp * self.chunk)
            flat = torch.nn.functional.pad(flat, (0, pad))
            shard = ring_reduce_scatter(flat, self.mesh, chunk=self.chunk,
                                        wire=self.wire) / self.dp
            full = ring_all_gather(shard, self.mesh, chunk=self.chunk,
                                   wire=self.wire)
            return full[:g.numel()].reshape(g.shape).to(g.dtype)
        (buf,) = quantize_rows_torch(g, self.wire)
        red = mean_over_ranks(buf, self.mesh).to(buf.dtype)
        return dequantize_rows_torch((red,), self.wire).to(g.dtype)

    def __call__(self, *inputs):
        params = {n: p for n, p in self.model.named_parameters()
                  if p.requires_grad}
        dev = next(iter(params.values())).device
        if self._opt_states is None:
            self._opt_states = self.optimizer.functional_init_states(
                {n: p.detach() for n, p in params.items()})
        lr = torch.full((), self.optimizer.get_lr(), dtype=torch.float32,
                        device=dev)
        loss, grads = loss_and_grads(self._loss_from, params,
                                     local_batch(inputs, self.mesh, dev))
        with torch.no_grad():
            grads = {n: self._reduce(g) for n, g in grads.items()}
            loss = mean_over_ranks(loss, self.mesh)
            new_params, self._opt_states = self.optimizer.functional_update(
                {n: p.detach() for n, p in params.items()}, grads,
                self._opt_states, lr=lr)
            for n, p in params.items():
                p.copy_(new_params[n])
            average_buffers(self.model, self.mesh)
        self.optimizer._global_step += 1
        return loss
