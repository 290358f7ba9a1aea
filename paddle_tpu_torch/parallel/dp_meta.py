"""The data-parallel steps that run the collectives themselves (port of
paddle_tpu/parallel/dp_meta.py): ``LocalSGDTrainStep`` (:85),
``CompressedAllReduceTrainStep`` (:236) and ``DGCTrainStep`` (:391); their
``_loss_closure`` (:53) is ``jit.loss_closure``.  All three are pure
data-parallel strategies (a mesh with another axis of size > 1 raises, as
the reference's meta-optimizer DAG) and take ``(model, loss_fn,
optimizer)`` and the global batch, of which each rank runs its slice (the
reference's ``shard_map`` with ``P("dp")`` inputs).  Each rank holds its
own replica of the model; every batch norm, ``SyncBatchNorm`` included,
normalises by the rank's own slice, as under the reference's
``shard_map``.  The returned loss is the mean of the ranks' losses.

**CompressedAllReduceTrainStep**: each rank computes its gradients, every
gradient is averaged over the ranks on the wire the step names, then each
rank applies the same full update, so the parameters stay replicated.

- ``f32``: the exact leg.  ``parallel.mesh.mean_over``: the ascending
  sum over the ranks of each rank's chunk divided by dp, then an
  all-gather: ``parallel/zero.py``'s f32 reduce-scatter, value for
  value, so the two steps agree bitwise whatever the backend (gloo's
  and NCCL's own all-reduce each choose their order).
- ``bf16`` / ``f16``: the gradients cross in the wire dtype, are added in
  f32 and rounded back to it, then decoded: the reference's CPU promotion
  of sub-f32 reduces (``:323-328``), here on every backend.
- ``ring=True`` (or ``FLAGS_zero_ring_collectives``): the quantized ring
  (``parallel/ring.py``) reduce-scatter then all-gather of each padded
  flat gradient, which admits int8 and int4 too.

Floating buffers (BatchNorm's running statistics, which each rank updates
from its own slice of the batch) are averaged over the ranks after the
step, in f32 and cast back (:338-346), never on the gradients' wire.
``recompute=True`` makes the rank's whole loss one recompute region
(reference :80-81), as in ``jit.TrainStep``.  Not ported, and raising: a
``grad_clip``, which the reference's step ignores.

**LocalSGDTrainStep**: every call is one local step of each replica on
its slice with its own optimizer state; while ``step + 1 < begin_step``
the gradients are averaged first (synchronous data parallelism); when
``step + 1 >= begin_step`` and ``(step + 1) % k == 0`` the parameters and
floating buffers are averaged after the update.  ``adaptive=True``
re-derives k on the host after each call from ``begin_step`` on,
``k = clip(ceil(sqrt(loss0 / loss) * init_k), 1, 16 * init_k)``
(:205-212).  ``sync_params`` averages and writes back, ``replica_params``
gathers the (dp, ...) replicas.  No clip, as the reference.

**DGCTrainStep** (Deep Gradient Compression): each rank keeps f32
momentum ``u`` and error ``v`` a floating parameter.  Before
``rampup_begin_step`` the exchange is dense, ``u = m u + pmean(g)``
returned as the gradient; then, at the sparsity of the stage (stages
advance every ``rampup_step`` calls), ``u = m u + g``, ``v = v + u``, the
top k = ``max(1, int(round(size * (1 - sparsity))))`` entries of |v| a
tensor (among ties the lower index, as ``lax.top_k``: the stable sort of
``tensor.search.topk``) go to every rank as (values, indices), are added
into a dense tensor in rank order and divided by dp, and the exchanged
entries of ``u`` and ``v`` are zeroed.  The gradient goes out in the
parameter's dtype into one replicated update (pair it with ``SGD``: the
momentum lives in the compressor).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from paddle_tpu_torch.distributed.wire import (COLLECTIVE_WIRE_DTYPES,
                                               dequantize_rows_torch,
                                               normalize_wire,
                                               quantize_rows_torch)
from paddle_tpu_torch.jit import loss_and_grads, loss_closure
from paddle_tpu_torch.parallel.mesh import (_require_pure_dp, get_mesh,
                                            mean_over)
from paddle_tpu_torch.parallel.ring import (ring_all_gather,
                                            ring_reduce_scatter)

__all__ = ["CompressedAllReduceTrainStep", "LocalSGDTrainStep",
           "DGCTrainStep"]


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


def average_buffers(model, mesh):
    """Every floating buffer of ``model`` replaced by its mean over the
    ranks, taken in f32 and cast back (the reference's ``pmean`` of the
    new buffers); nothing to do at world size 1."""
    if mesh.shape.get("dp", 1) == 1:
        return
    for b in model.buffers():
        if b.is_floating_point():
            b.copy_(mean_over(mesh.group, b.float()).to(b.dtype))


class _LocalDPStep:
    """What the two shard_map-style steps below share: the replica's
    parameters, the optimizer state, the learning rate and the rank's loss
    and gradients."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh, who,
                 amp_level, amp_dtype, recompute):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh or get_mesh()
        _require_pure_dp(self.mesh, who)
        self.dp = self.mesh.shape.get("dp", 1)
        self.amp_level = amp_level
        self.amp_dtype = _amp_dtype(amp_dtype)
        self.recompute = recompute
        self._loss_from = loss_closure(model, loss_fn, amp_level,
                                       self.amp_dtype, recompute)
        self._opt_states = None
        self._step = 0

    def _params(self) -> dict:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def _local(self, inputs):
        """(params, lr, the rank's f32 loss, its gradients)."""
        params = self._params()
        dev = next(iter(params.values())).device
        if self._opt_states is None:
            self._opt_states = self.optimizer.functional_init_states(
                {n: p.detach() for n, p in params.items()})
        lr = torch.full((), self.optimizer.get_lr(), dtype=torch.float32,
                        device=dev)
        loss, grads = loss_and_grads(self._loss_from, params,
                                     local_batch(inputs, self.mesh, dev))
        return params, lr, loss, grads

    def _update(self, params, grads, lr):
        new_params, self._opt_states = self.optimizer.functional_update(
            {n: p.detach() for n, p in params.items()}, grads,
            self._opt_states, lr=lr)
        for n, p in params.items():
            p.copy_(new_params[n])

    def _average_params(self):
        """Parameters and floating buffers replaced by their mean over the
        ranks (f32, cast back)."""
        for p in self._params().values():
            p.copy_(mean_over(self.mesh.group, p.detach().float()).to(
                p.dtype))
        average_buffers(self.model, self.mesh)


class CompressedAllReduceTrainStep(_LocalDPStep):
    """DP train step whose gradient all-reduce runs in ``compress_dtype``
    (reference ``:236``): construct with ``(model, loss_fn, optimizer)``,
    call with the global batch, read back the f32 loss."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 compress_dtype="float16", amp_level=None,
                 amp_dtype="bfloat16", recompute: bool = False,
                 ring: Optional[bool] = None, chunk: int = 256):
        from paddle_tpu_torch.framework.flags import flag
        super().__init__(model, loss_fn, optimizer, mesh,
                         "compressed-allreduce", amp_level, amp_dtype,
                         recompute)
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
        red = mean_over(self.mesh.group, buf).to(buf.dtype)
        return dequantize_rows_torch((red,), self.wire).to(g.dtype)

    def __call__(self, *inputs):
        params, lr, loss, grads = self._local(inputs)
        with torch.no_grad():
            self._update(params, {n: self._reduce(g)
                                  for n, g in grads.items()}, lr)
            average_buffers(self.model, self.mesh)
            loss = mean_over(self.mesh.group, loss)
        self.optimizer._global_step += 1
        # the replica-parity probe (reference :384-387): a compressed
        # reduce that drifted the replicas apart shows here
        from paddle_tpu_torch.parallel import parity
        parity.maybe_observe(self, mesh=self.mesh)
        return loss


class LocalSGDTrainStep(_LocalDPStep):
    """k local steps, then the replicas average (reference ``:85``)."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 k_steps: int = 4, begin_step: int = 1,
                 adaptive: bool = False, amp_level=None,
                 amp_dtype="bfloat16", recompute=False):
        super().__init__(model, loss_fn, optimizer, mesh, "LocalSGD",
                         amp_level, amp_dtype, recompute)
        self.k_steps = int(k_steps)
        self._init_k = int(k_steps)
        self.begin_step = int(begin_step)
        self.adaptive = adaptive
        self._first_loss: Optional[float] = None

    def __call__(self, *inputs):
        params, lr, loss, grads = self._local(inputs)
        step = self._step
        with torch.no_grad():
            if step + 1 < self.begin_step:
                grads = {n: mean_over(self.mesh.group, g.float()).to(g.dtype)
                         for n, g in grads.items()}
            self._update(params, grads, lr)
            if step + 1 >= self.begin_step and \
                    (step + 1) % self.k_steps == 0:
                self._average_params()
            loss = mean_over(self.mesh.group, loss)
        self._step += 1
        if self.adaptive and self._step >= self.begin_step:
            lf = float(loss)
            if self._first_loss is None:
                self._first_loss = max(lf, 1e-12)
            ratio = max(self._first_loss / max(lf, 1e-12), 1.0)
            self.k_steps = int(min(max(1, math.ceil(
                math.sqrt(ratio) * self._init_k)), 16 * self._init_k))
        return loss

    @torch.no_grad()
    def sync_params(self):
        """Average the replicas' parameters and floating buffers and write
        them into every rank's model (call on every rank before eval or
        save)."""
        self._average_params()

    def replica_params(self) -> dict:
        """{name: (dp, ...)}: every rank's parameter, stacked in rank
        order (a collective: every rank calls it)."""
        return {n: self.mesh.group.all_gather(p.detach())
                for n, p in self._params().items()}


class DGCTrainStep(_LocalDPStep):
    """Top-k sparse gradient exchange with momentum correction and error
    feedback (reference ``:391``)."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 momentum: float = 0.9, sparsity=(0.999,),
                 rampup_begin_step: int = 0, rampup_step: int = 1,
                 amp_level=None, amp_dtype="bfloat16", recompute=False):
        super().__init__(model, loss_fn, optimizer, mesh, "DGC", amp_level,
                         amp_dtype, recompute)
        self.momentum = float(momentum)
        self.sparsity = [float(s) for s in sparsity]
        self.rampup_begin_step = int(rampup_begin_step)
        self.rampup_step = max(1, int(rampup_step))
        self._uv = None            # ({name: u}, {name: v}), f32, per rank
        self.stages_seen = set()   # the sparsities the calls have run
        # {name: (indices, values)} this rank sent at the last sparse call
        self.exchanged = {}

    def _current_sparsity(self) -> float:
        if self._step < self.rampup_begin_step:
            return 0.0
        stage = (self._step - self.rampup_begin_step) // self.rampup_step
        return self.sparsity[min(stage, len(self.sparsity) - 1)]

    @staticmethod
    def top_k(size: int, sparsity: float) -> int:
        """Entries a rank sends of a tensor of ``size`` values."""
        return max(1, int(round(size * (1.0 - sparsity))))

    def _compress(self, g, u, v, sparsity):
        """One tensor: (gradient out, new u, new v)."""
        from paddle_tpu_torch.tensor.search import topk
        m = self.momentum
        g = g.to(torch.float32)
        if sparsity <= 0.0:
            u = m * u + mean_over(self.mesh.group, g)
            return u, u, v
        u = m * u + g
        v = v + u
        flat = v.reshape(-1)
        size = flat.shape[0]
        _, idx = topk(flat.abs(), self.top_k(size, sparsity))
        vals = flat[idx]
        self._sent = (idx, vals)
        group = self.mesh.group
        dense = torch.zeros(size, dtype=torch.float32,
                            device=flat.device).index_add_(
            0, group.all_gather(idx).reshape(-1),
            group.all_gather(vals).reshape(-1)) / self.dp
        flat_v = flat.clone()
        flat_v[idx] = 0.0
        flat_u = u.reshape(-1).clone()
        flat_u[idx] = 0.0
        return (dense.reshape(v.shape), flat_u.reshape(u.shape),
                flat_v.reshape(v.shape))

    def __call__(self, *inputs):
        params, lr, loss, grads = self._local(inputs)
        if self._uv is None:
            self._uv = tuple({n: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                              for n, p in params.items()
                              if p.is_floating_point()} for _ in range(2))
        sp = self._current_sparsity()
        self.stages_seen.add(sp)
        u, v = self._uv
        with torch.no_grad():
            out = {}
            for n, g in grads.items():
                if n in u:
                    agg, u[n], v[n] = self._compress(g, u[n], v[n], sp)
                    out[n] = agg.to(g.dtype)
                    if sp > 0.0:
                        self.exchanged[n] = self._sent
                else:
                    out[n] = mean_over(self.mesh.group, g.float()).to(g.dtype)
            self._update(params, out, lr)
            loss = mean_over(self.mesh.group, loss)
        self.optimizer._global_step += 1
        self._step += 1
        return loss
