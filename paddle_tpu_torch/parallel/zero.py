"""ZeRO-style sharded weight update over the ``dp`` axis (port of
paddle_tpu/parallel/zero.py).

Plain data parallelism all-reduces full gradients and then applies the
same update to the same full parameters on every replica, each holding a
full copy of the optimizer's moments.  :class:`ShardedUpdateTrainStep`
removes both redundancies:

1. **reduce-scatter**: each rank runs forward and backward on its slice
   of the global batch; every gradient is flattened, padded to a multiple
   of ``dp * chunk`` and reduce-scattered, so a rank receives the mean of
   the 1/dp chunk it owns;
2. **sharded update**: the optimizer's update (global-norm clip, decay,
   moments) runs on the owned chunk only, and the moments live as flat
   per-rank shards: optimizer-state bytes per replica fall to about 1/dp;
3. **all-gather**: the updated chunks are gathered back into the full
   parameters of every rank.

``wire_dtype`` (``FLAGS_zero_wire_dtype``, default bf16) sets what both
legs ship (``distributed/wire.py``): ``f32``, the exact leg, whose
trajectory is element for element the replicated step's (the update is
elementwise); ``bf16``; ``int8`` (a scale per ``chunk`` values) and
``int4`` (two nibbles a byte, a scale per chunk).  A quantized
reduce-scatter is encode, all-to-all, decode, then a local sum (a
collective cannot add encoded payloads); a quantized all-gather decodes
every chunk, the rank's own included, so the ranks' parameters stay
bitwise equal.  The quantized all-gather re-encodes the parameters
themselves every step, with no f32 master: a move smaller than half the
grid step rounds back (reference semantics).

``ring=True`` (``FLAGS_zero_ring_collectives``) runs both legs as the
quantized ring of ``parallel/ring.py``: the same wire bytes, one
neighbour hop at a time.  The f32 wire keeps the plain legs either way.

Exactness: the f32 reduce-scatter is an all-to-all then the ascending sum
over the ranks divided by dp (``mesh.ordered_sum``), the replicated step's
mean (``dp_meta.CompressedAllReduceTrainStep``, ``mesh.mean_over``) the
same reduce-scatter then an all-gather: the two agree bitwise on gloo
and NCCL alike, whose own ``reduce_scatter`` and ``all_reduce`` choose
their order.  On a CUDA tensor
every int8 / int4 encode runs kernel #9 (``ops/cuda/ring_quant.py``): one
launch a parameter in each unfused leg.

Floating buffers (BatchNorm's running statistics) are averaged over the
ranks after the update, in f32 and cast back, never on the wire
(reference ``:363-369``; ``dp_meta.average_buffers``).  ``recompute=True``
makes each rank's loss one recompute region, as in ``jit.TrainStep``
(``jit.loss_closure``; reference ``:139``, ``:174``, ``:287``).

The host planes see a step as the reference's (``:441-558``): the
``zero.collective`` fault point once per leg at the head of the step, an
injected drop re-issued up to ``collective_retries`` times before any leg
runs (so a retried step is bit-identical; ``zero_collective_retries_total``,
and a ``zero.collective_failed`` flight event when the retries run out);
a ``zero.step`` span holding ``zero.reduce_scatter`` / ``zero.update`` /
``zero.all_gather`` spans with the legs' wire bytes, around the host's
issue of each leg (the reference waits for the device inside them when
tracing, the port adds no synchronisation); ``opt_state_bytes_per_replica``,
``zero_collective_bytes_per_step`` / ``_total``, ``train_step_ms``,
``train_steps_total``, the health detector and the memory sample.  On the
ranks of a ``LoopbackWorld`` only rank 0's thread consults the fault point
and records, as the reference's one controller does.

``FLAGS_numerics`` arms the numerics plane (reference ``:376-389``,
``:441-513``): ``numerics.compute_aux`` of the pre-clip gradient chunks
and the chunks before and after the update, its sums taken over the dp
group in rank order and its maxima over it, so every rank holds the
replicated step's global vectors; rank 0 publishes the record.

Checkpoint interop (reference ``:572-640``): ``checkpoint_extra_meta``
stamps the shard bookkeeping, ``checkpoint_opt_states`` hands
``distributed.checkpoint`` each rank's moment chunks under their index
windows (every rank writes its own files, the reference's names), and
``load_checkpoint_state`` / ``adopt_opt_state`` take moments saved at any
dp width, or by a replicated step, onto this step's own chunks.

The replica-parity probe (``parallel/parity.py``) checks the replicated
parameters after each step when ``FLAGS_replica_parity`` is armed (the
moment chunks differ by design and are skipped).

Not ported, each raising or absent: LARS (``LarsMomentum``, rejected by
name: its per-parameter norms would be taken over 1/dp chunks), a grad clip
without ``functional_clip`` (the reference skips it) and ``analyze``.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.distributed.wire import (COLLECTIVE_WIRE_DTYPES,
                                               dequantize_rows_torch,
                                               normalize_wire,
                                               quantize_rows_torch,
                                               wire_nbytes)
from paddle_tpu_torch.framework import chaos, health, monitor, numerics
from paddle_tpu_torch.framework.observability import flight, tracer
from paddle_tpu_torch.jit import loss_and_grads, loss_closure
from paddle_tpu_torch.parallel.dp_meta import (_amp_dtype, average_buffers,
                                               local_batch)
from paddle_tpu_torch.parallel.mesh import (_require_pure_dp, get_mesh,
                                            lead_thread, mean_over,
                                            ordered_sum)
from paddle_tpu_torch.parallel.ring import (ring_all_gather,
                                            ring_reduce_scatter)

__all__ = ["ShardSpec", "ShardedUpdateTrainStep", "build_shard_specs",
           "init_state_shards", "f32_all_gather", "sharded_clip"]


class ShardSpec(NamedTuple):
    """Flat-shard bookkeeping of one parameter: logical ``size``,
    ``padded`` length (a multiple of dp * chunk) and ``shard_len =
    padded // dp`` (reference ``:101``)."""
    size: int
    padded: int
    shard_len: int


def build_shard_specs(params: Dict[str, torch.Tensor], dp: int,
                      chunk: int = 256) -> Dict[str, ShardSpec]:
    """{name: ShardSpec}: each leaf flattens to ``size`` values, padded to
    a multiple of ``dp * chunk``, whatever the wire (reference ``:111``)."""
    specs = {}
    q = dp * chunk
    for n, p in params.items():
        size = max(1, p.numel())
        padded = int(math.ceil(size / q) * q)
        specs[n] = ShardSpec(size=size, padded=padded, shard_len=padded // dp)
    return specs


def init_state_shards(optimizer, params: Dict[str, torch.Tensor],
                      specs: Dict[str, ShardSpec], rank: int) -> dict:
    """The optimizer's state for the flat chunk ``rank`` owns of every
    parameter: {name: {slot: (shard_len,) chunk or scalar}} (reference
    ``:150-175``)."""
    shards = {}
    for n, p in params.items():
        if not p.is_floating_point():
            raise TypeError(f"sharded update needs floating params; "
                            f"{n!r} is {p.dtype}")
        spec = specs[n]
        flat = F.pad(p.detach().reshape(-1), (0, spec.padded - spec.size))
        slots = {}
        # the in-tree optimizers' states are elementwise or scalars, so
        # the flat init is the flattened full init
        for k, v in optimizer.init_state(flat).items():
            if v.dim() == 1 and v.shape[0] == spec.padded:
                slots[k] = v[rank * spec.shard_len:
                             (rank + 1) * spec.shard_len].clone()
            elif v.dim() == 0:
                slots[k] = v
            else:
                raise TypeError(
                    f"optimizer slot {k!r} for {n!r} has shape "
                    f"{tuple(v.shape)}: neither elementwise nor scalar; "
                    "the sharded update cannot place it")
        shards[n] = slots
    return shards


def f32_all_gather(shard: torch.Tensor, group) -> torch.Tensor:
    """The f32 leg: (shard_len,) chunk -> (padded,) vector of every rank's
    chunk in rank order."""
    return group.all_gather(shard).reshape(-1)


def sharded_clip(optimizer, gshards: dict, group) -> dict:
    """The optimizer's global-norm clip over the sharded gradients: the
    ranks' sums of squares added in rank order (padding adds exact
    zeros), reference ``:340-354``."""
    clip = getattr(optimizer, "_grad_clip", None)
    if clip is None:
        return gshards
    if not hasattr(clip, "clip_norm"):
        return clip.functional_clip(gshards)
    sq = sum(torch.sum(g.float() ** 2) for g in gshards.values())
    gn = torch.sqrt(ordered_sum(group.all_gather(sq)))
    scale = torch.clamp(clip.clip_norm / torch.clamp(gn, min=1e-12),
                        max=1.0)
    return {n: (g * scale).to(g.dtype) for n, g in gshards.items()}


class ShardedUpdateTrainStep:
    """``TrainStep`` with a dp-sharded weight update and, optionally,
    quantized collectives (reference ``:127``): construct with ``(model,
    loss_fn, optimizer)``, call with the global batch (each rank takes its
    slice), read back the f32 loss, the mean over the ranks."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 wire_dtype: Optional[str] = None, chunk: int = 256,
                 amp_level=None, amp_dtype="bfloat16",
                 recompute: bool = False, donate: bool = True,
                 ring: Optional[bool] = None, collective_retries: int = 2):
        from paddle_tpu_torch.framework.flags import flag
        if type(optimizer).__name__ == "LarsMomentum":
            # LARS takes a trust ratio from per-parameter norms; over 1/dp
            # chunks those norms are wrong and training silently diverges
            raise TypeError(
                "ShardedUpdateTrainStep cannot shard a norm-per-"
                "parameter optimizer (LarsMomentum): the trust-ratio "
                "norms would be computed over 1/dp chunks.  Use the "
                "replicated TrainStep/CompressedAllReduceTrainStep.")
        clip = getattr(optimizer, "_grad_clip", None)
        if clip is not None and not hasattr(clip, "functional_clip"):
            raise NotImplementedError(
                f"grad_clip {type(clip).__name__} has no functional_clip: "
                "the reference's sharded step skips it silently, the port "
                "does not train without it")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh or get_mesh()
        _require_pure_dp(self.mesh, "the sharded weight update")
        self.dp = self.mesh.shape.get("dp", 1)
        self.wire = normalize_wire(
            flag("zero_wire_dtype") if wire_dtype is None else wire_dtype,
            known=COLLECTIVE_WIRE_DTYPES)
        self.ring = bool(flag("zero_ring_collectives")
                         if ring is None else ring)
        if int(chunk) < 1:
            raise ValueError("chunk must be >= 1")
        self.chunk = int(chunk)
        self.amp_level = amp_level
        self.amp_dtype = _amp_dtype(amp_dtype)
        self.donate = donate
        self.collective_retries = int(collective_retries)
        self._loss_from = loss_closure(model, loss_fn, amp_level,
                                       self.amp_dtype, recompute)
        self._specs: Optional[Dict[str, ShardSpec]] = None
        self._opt_shards: Optional[dict] = None

    def _params(self) -> dict:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    # -- sharded optimizer state --------------------------------------------
    def _ensure_specs(self):
        if self._specs is None:
            self._specs = build_shard_specs(self._params(), self.dp,
                                            self.chunk)

    def _ensure_state(self):
        if self._opt_shards is not None:
            return
        self._ensure_specs()
        self._opt_shards = init_state_shards(self.optimizer, self._params(),
                                             self._specs, self.mesh.rank)
        if lead_thread():
            monitor.stat_set("opt_state_bytes_per_replica",
                             self.opt_state_bytes_per_replica())

    @property
    def _opt_states(self):
        """This rank's optimizer state: {name: {slot: tensor}}, each
        elementwise slot the (shard_len,) chunk the rank owns."""
        return self._opt_shards

    def opt_state_bytes_per_replica(self) -> int:
        """Bytes of optimizer state one rank holds: its shards of the
        elementwise slots and the scalars whole (reference ``:244``)."""
        self._ensure_state()
        return sum(v.numel() * v.element_size()
                   for slots in self._opt_shards.values()
                   for v in slots.values())

    def collective_wire_bytes(self, wire: Optional[str] = None
                              ) -> Dict[str, int]:
        """Per-rank wire bytes a step for each leg: ``(dp - 1)`` encoded
        shards of every padded leaf, on :attr:`wire` or the ``wire`` given
        (reference ``:256``)."""
        self._ensure_specs()
        wire = self.wire if wire is None else normalize_wire(
            wire, known=COLLECTIVE_WIRE_DTYPES)
        per = sum(wire_nbytes(s.shard_len, wire, row=self.chunk)
                  for s in self._specs.values()) * (self.dp - 1)
        return {"reduce_scatter": per, "all_gather": per}

    # -- the legs (reference :290-319) --------------------------------------
    def _reduce_scatter(self, gflat: torch.Tensor) -> torch.Tensor:
        """(padded,) local gradient -> (shard_len,) owned mean chunk."""
        dp, mesh, wire = self.dp, self.mesh, self.wire
        if self.ring:
            return ring_reduce_scatter(gflat, mesh, chunk=self.chunk,
                                       wire=wire) / dp
        if wire == "f32":
            return ordered_sum(mesh.group.all_to_all(gflat.reshape(dp, -1))
                               .float()) / dp
        bufs = quantize_rows_torch(gflat.reshape(dp, -1, self.chunk), wire)
        ex = tuple(mesh.group.all_to_all(b) for b in bufs)
        return ordered_sum(dequantize_rows_torch(ex, wire)).reshape(-1) / dp

    def _all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """(shard_len,) updated chunk -> (padded,) full leaf, the same bits
        on every rank."""
        mesh, wire = self.mesh, self.wire
        if self.ring:
            return ring_all_gather(shard, mesh, chunk=self.chunk, wire=wire)
        if wire == "f32":
            return f32_all_gather(shard, mesh.group)
        bufs = quantize_rows_torch(shard.reshape(-1, self.chunk), wire)
        got = tuple(mesh.group.all_gather(b) for b in bufs)
        return dequantize_rows_torch(got, wire).reshape(-1)

    def _clip(self, gshards: dict) -> dict:
        return sharded_clip(self.optimizer, gshards, self.mesh.group)

    # -- chaos (reference :455-475) -----------------------------------------
    def _collective_guard(self):
        """Consult ``zero.collective`` once a leg at the head of the step.
        Nothing has run yet, so an injected drop is simply re-issued
        (bounded): the step that follows is the one without the fault."""
        for leg in ("reduce_scatter", "all_gather"):
            attempt = 0
            while True:
                try:
                    chaos.fault_point("zero.collective", meta={"leg": leg})
                    break
                except chaos.InjectedFault:
                    attempt += 1
                    monitor.stat_add("zero_collective_retries_total")
                    if attempt > self.collective_retries:
                        flight.record("zero.collective_failed",
                                      severity="error", leg=leg,
                                      attempts=attempt)
                        raise

    # -- the step -----------------------------------------------------------
    # -- checkpoint interop (reference :572-640) ----------------------------
    def checkpoint_extra_meta(self) -> dict:
        """Shard bookkeeping stamped into the checkpoint's metadata, so a
        restore at another dp width strips the save-time padding."""
        self._ensure_state()
        return {"zero": {
            "dp": self.dp, "chunk": self.chunk, "wire": self.wire,
            "leaves": {n: {"size": s.size, "padded": s.padded}
                       for n, s in self._specs.items()}}}

    def checkpoint_group(self):
        """The ranks that write one checkpoint together."""
        return self.mesh.group

    def checkpoint_opt_states(self) -> dict:
        """This rank's optimizer state for ``distributed.checkpoint``:
        each elementwise slot a ``ShardedLeaf`` window of the (padded,)
        vector (the whole vector at dp = 1, as the reference's
        unsplit shard), scalars as they are."""
        from paddle_tpu_torch.distributed.checkpoint import ShardedLeaf
        self._ensure_state()
        r = self.mesh.rank
        out = {}
        for n, slots in self._opt_shards.items():
            spec = self._specs[n]
            window = (slice(None),) if self.dp == 1 else (
                slice(r * spec.shard_len, (r + 1) * spec.shard_len),)
            out[n] = {k: ShardedLeaf((spec.padded,), v.dtype,
                                     [(window, v)]) if v.dim() == 1 else v
                      for k, v in slots.items()}
        return out

    def adopt_opt_state(self, tree, zero_meta: Optional[dict] = None):
        """Install checkpointed moments, resharding as needed: flat padded
        vectors of a ZeRO checkpoint at any save-time dp
        (``zero_meta["leaves"]`` names the logical sizes) or
        parameter-shaped leaves of a replicated step's; scalars whole."""
        self._ensure_state()
        saved = (zero_meta or {}).get("leaves", {})
        r = self.mesh.rank
        new = {}
        for n, slots in tree.items():
            if n not in self._specs:
                raise ValueError(f"checkpoint moment {n!r} has no "
                                 "matching parameter")
            spec = self._specs[n]
            dev = self._opt_shards[n][next(iter(self._opt_shards[n]))].device
            out = {}
            for k, v in slots.items():
                if v.dim() == 0:
                    out[k] = v.to(dev)
                    continue
                flat = v.reshape(-1)
                meta_pad = saved.get(n, {}).get("padded")
                if flat.numel() == spec.size:
                    pass                     # replicated / logical leaf
                elif flat.numel() in (meta_pad, spec.padded):
                    flat = flat[:spec.size]  # strip save-time padding
                else:
                    raise ValueError(
                        f"moment {n!r}/{k!r} has {flat.numel()} elements; "
                        f"expected {spec.size} (logical) or a padded "
                        f"length ({meta_pad or spec.padded})")
                flat = F.pad(flat, (0, spec.padded - spec.size))
                out[k] = flat[r * spec.shard_len:
                              (r + 1) * spec.shard_len].to(dev).clone()
            new[n] = out
        self._opt_shards = new
        if lead_thread():
            monitor.stat_set("opt_state_bytes_per_replica",
                             self.opt_state_bytes_per_replica())

    def load_checkpoint_state(self, state: dict,
                              zero_meta: Optional[dict] = None):
        """Install a full checkpoint ``state`` tree (params, buffers,
        opt_states, global_step): ``checkpoint.load_train_state``'s hook
        for this step."""
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(state["params"][n].to(p.device))
            for n, b in self.model.named_buffers():
                if b is not None and n in state.get("buffers", {}):
                    b.copy_(state["buffers"][n].to(b.device))
        self._specs = None
        self._opt_shards = None
        self._ensure_state()
        opt_states = state.get("opt_states") or {}
        if opt_states:
            self.adopt_opt_state(opt_states, zero_meta)
        self.optimizer._global_step = int(state.get("global_step", 0))
        return state

    def __call__(self, *inputs):
        t_start = time.perf_counter()
        lead = lead_thread()
        params = self._params()
        self._ensure_state()
        wire_bytes = self.collective_wire_bytes()
        armed = numerics.enabled()
        span = tracer.start_span if lead else _no_span
        with span("zero.step", attrs={
                "step": int(self.optimizer._global_step), "wire": self.wire,
                "dp": self.dp, "ring": self.ring}):
            if lead:
                self._collective_guard()
            loss, aux = self._step(params, inputs, span, wire_bytes, armed)
            if armed and lead:
                rec = numerics.NumericsRecord(
                    list(self._specs), aux,
                    step=int(self.optimizer._global_step))
                numerics.publish(rec)
                self.last_numerics = rec
        self.optimizer._global_step += 1
        if lead:
            per_step = (wire_bytes["reduce_scatter"]
                        + wire_bytes["all_gather"])
            monitor.stat_set("zero_collective_bytes_per_step", per_step)
            monitor.stat_add("zero_collective_bytes_total", per_step)
            step_ms = (time.perf_counter() - t_start) * 1e3
            monitor.observe("train_step_ms", step_ms)
            monitor.stat_add("train_steps_total")
            health.observe("train_step_ms", step_ms)
            health.maybe_sample_memory(lambda: {
                "params": sum(p.numel() * p.element_size()
                              for p in self.model.parameters()),
                "opt_state": self.opt_state_bytes_per_replica(),
                "buffers": sum(b.numel() * b.element_size()
                               for b in self.model.buffers())})
        # the replica-parity probe over the replicated parameters
        # (reference :565-568); the moment chunks differ by design
        from paddle_tpu_torch.parallel import parity
        parity.maybe_observe(self, mesh=self.mesh)
        return loss

    def _step(self, params, inputs, span, wire_bytes, armed=False):
        dev = next(iter(params.values())).device
        lr = torch.full((), self.optimizer.get_lr(), dtype=torch.float32,
                        device=dev)
        loss, grads = loss_and_grads(self._loss_from, params,
                                     local_batch(inputs, self.mesh, dev))
        lo = self.mesh.rank
        leg = {"category": "collective", "wire": self.wire,
               "ring": self.ring}
        with torch.no_grad():
            gshards, pshards = {}, {}
            with span("zero.reduce_scatter", attrs={
                    **leg, "bytes": wire_bytes["reduce_scatter"]}):
                for n, p in params.items():
                    spec = self._specs[n]
                    pad = (0, spec.padded - spec.size)
                    g = grads.pop(n)
                    gshards[n] = self._reduce_scatter(
                        F.pad(g.reshape(-1), pad)).to(g.dtype)
                    pshards[n] = F.pad(p.detach().reshape(-1), pad)[
                        lo * spec.shard_len:(lo + 1) * spec.shard_len]
            # the numerics view: the PRE-clip chunks (reference :336-339)
            # and the chunks before the update writes them in place
            before = ({n: t.clone() for n, t in pshards.items()}
                      if armed else None)
            with span("zero.update", attrs={
                    "opt_state_bytes_per_replica":
                        monitor.get_stat("opt_state_bytes_per_replica")}):
                new_pshards, self._opt_shards = \
                    self.optimizer.functional_update(
                        pshards, self._clip(gshards), self._opt_shards,
                        lr=lr, donate=self.donate)
            with span("zero.all_gather", attrs={
                    **leg, "bytes": wire_bytes["all_gather"]}):
                for n, p in params.items():
                    full = self._all_gather(new_pshards[n].to(p.dtype))
                    p.copy_(full[:self._specs[n].size].view_as(p))
            average_buffers(self.model, self.mesh)
            loss = mean_over(self.mesh.group, loss)
            aux = numerics.compute_aux(
                gshards, before, new_pshards, loss,
                group=self.mesh.group) if armed else None
            return loss, aux


def _no_span(name, attrs=None):
    """The span of a thread that does not record (``lead_thread``)."""
    return contextlib.nullcontext()
