"""``ShardedTrainStep`` over the data axes, and ``shard_module`` (port of
paddle_tpu/parallel/sharded.py :43-262).

The reference compiles one pjit program over the global batch and lets
GSPMD place it: each ``dp`` x ``sharding`` shard runs its slice of dim 0
of every input, the gradients meet in a reduction XLA inserts, and the
ZeRO stages are sharding layouts of the optimizer state (stage >= 1),
the gradients (stage >= 2) and the parameters (stage 3) over
``sharding`` (over ``dp`` where ``sharding`` is 1).  The port runs that
program by hand on each rank, and at any data-axis size gives what
``jit.TrainStep`` gives on the global batch (bitwise at one rank):

- the rank takes its slice of dim 0 of every input with ndim >= 1 (a
  batch that does not divide raises); with ``accumulate_steps = k`` the
  global batch is cut into k micro-batches first and the rank takes its
  slice of each, as the reference's scan of sharded micro-batches does;
- every batch norm normalises by the statistics of the global batch
  (``nn.functional.norm.batch_stats_over``): its per-channel sums cross
  the ranks in rank order through a differentiable sum whose backward
  sums the gradients the same way, so the running statistics and the
  gradients are the global batch's, for ``BatchNorm`` and
  ``SyncBatchNorm`` alike (GSPMD's semantics); a chain of tokens makes
  every rank's backward meet those sums in one order;
- the loss is the mean of the ranks' losses and every gradient the mean
  over the data axes (``mesh.mean_over``: a reduce-scatter summing each
  chunk in rank order, then an all-gather, ``parallel/zero.py``'s f32
  legs), so stages 0-3 agree bitwise;
- stage 0 applies the replicated update (``jit.apply_functional_update``);
  stage >= 1 keeps the optimizer state as flat shards of every parameter
  (``zero.build_shard_specs``, ``zero.init_state_shards``), updates the
  rank's chunk and all-gathers the chunks; stage >= 2 reduce-scatters the
  gradients onto the chunks instead of reducing them whole; stage 3 keeps
  only the rank's chunk of each parameter between steps (the module's
  parameters are empty then) and all-gathers them before the forward:
  :meth:`ShardedTrainStep.gather_params` puts them back for reading.

Tensor and sequence parallelism (reference ``:120-158``): on a mesh with
``mp`` or ``sp`` > 1 the step hands the mesh to every mp-aware module
(``apply_mesh``: ``GPT``, the layers of ``distributed/tp_layers.py``),
which then hold this rank's shards of their split parameters.  The data
axes stay ``dp`` and ``sharding``: the ``mp`` and ``sp`` ranks of one
data coordinate take the same batch rows (GPT's ``sp`` ranks take
different positions of them).  A parameter split over ``mp`` keeps its
rank-local gradient; a replicated one's is the same on every ``mp`` rank
(bitwise: the sums inside the model run in rank order); where a module
splits the sequence (``splits_sequence``, GPT) every gradient is summed
over ``sp`` (the sp ranks of any other model are replicas), then
averaged over the data axes.  The loss is the global one on every rank.
ZeRO stages 1-3 chunk each rank's mp shard over ``sharding`` (or
``dp``).  :meth:`ShardedTrainStep.gather_params`
returns the reference's full layout ({name: tensor}, GPT's ``qkv``
permutation undone).  ``input_specs`` gives each input the axes each of
its dims is split over (one spec an input, as the reference's
``PartitionSpec``); the rank takes its slice along each, the default
being dim 0 over the data axes.

The pipeline (reference ``:120-158`` with ``parallel/pipeline.py``): on a
mesh with ``pp`` > 1 the step hands the mesh to the pipeline-aware
modules (``GPT``), each ``pp`` rank then holding its stage's layers;
the ``pp`` ranks of one data coordinate take the same rows and each data
group runs its own pipeline.  A parameter every stage holds whole (GPT's
``wte``, ``wpe``, ``lnf_*``) gets the same gradient on each (the model's
schedule hands each stage the last stage's head gradient and stage 0's
embedding gradient), so it is neither summed nor averaged over ``pp``;
the gradients are averaged over the data axes as at pp = 1.  ZeRO stages
1-3 chunk each rank's stage over ``sharding`` (or ``dp``);
:meth:`ShardedTrainStep.gather_params` concatenates the stages.

``FLAGS_numerics`` (reference ``:161-176``): each rank computes the
numerics aux of its pieces, and the sums of squares and non-finite counts
add over ``mp`` for the split leaves, over ``pp`` for the stacked layers
and over the ZeRO group for the chunks, in rank order
(``numerics.sum_aux_over``), so every rank holds the reference's
replicated record; disarmed, the step is unchanged.

Raising: a mesh with an ``ep`` axis of size > 1; a parameter whose
``DistAttr`` splits it over ``mp`` (> 1) but which no mp-aware layer or
model holds in shards (a plain ``Linear`` under ``shard_module`` rules;
GPT, Bert, the tensor-parallel layers and ``ps.ShardedEmbedding`` hold
theirs), rather than keeping it whole;
at ``mp`` or ``pp`` > 1 a gradient clip other than ``ClipGradByValue``
(its norms would be taken over shards or one stage's layers); a
per-parameter-norm optimizer
(``Lamb``, ``LarsMomentum``) whose state is sharded over more than one
rank (its norms would be taken over chunks); ``lower_hlo``, the
reference's XLA text (item 8); ``recompute=True`` on the card on ranks
simulated by a ``LoopbackWorld`` for a model with batch norms, or on a
mesh with ``mp``, ``sp`` or ``pp`` > 1 (the replay would run the ranks'
sums or the stages' sends on the autograd engine's one device thread,
where one rank's wait blocks the other's).
"""
from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from paddle_tpu_torch.framework import numerics
from paddle_tpu_torch.jit import TrainStep, apply_functional_update, \
    loss_and_grads
from paddle_tpu_torch.nn.functional.norm import batch_stats_over
from paddle_tpu_torch.nn.layer.norm import _BatchNormBase
from paddle_tpu_torch.parallel import tp
from paddle_tpu_torch.parallel.mesh import (DistAttr, HybridTopology,
                                            _local_slice, get_mesh,
                                            in_loopback, mean_over,
                                            ordered_sum,
                                            require_no_model_parallel,
                                            sum_over)
from paddle_tpu_torch.parallel.pipeline import full_stages
from paddle_tpu_torch.parallel.zero import (build_shard_specs,
                                            f32_all_gather,
                                            init_state_shards, sharded_clip)

__all__ = ["ShardedTrainStep", "shard_module"]


def shard_module(module, rules: Dict[str, tuple]):
    """Attach ``DistAttr``s to parameters by name-regex rules, e.g.
    ``{r"qkv_proj\\.weight": (None, "mp")}`` (reference ``:43``)."""
    for name, p in module.named_parameters():
        for pat, spec in rules.items():
            if re.search(pat, name):
                p.dist_attr = DistAttr(spec)
                break
    return module


class _GroupSum(torch.autograd.Function):
    """(token, x) -> (the sum of x over the group's ranks in rank order, a
    new token); the backward sums the gradients the same way.  The token
    chains the sums of one forward, so every rank's backward meets them in
    reverse order of the forward.  On ranks simulated as threads on the
    card the sums cross on the host, which puts the backward node on the
    rank's own thread, not on the autograd engine's one device thread
    (there one rank's wait would block the other's)."""

    @staticmethod
    def forward(ctx, token, x, group):
        ctx.group, ctx.device = group, x.device
        ctx.hop = x.is_cuda and in_loopback()
        xs = x.detach().cpu() if ctx.hop else x.detach()
        return ordered_sum(group.all_gather(xs)), token.detach().clone()

    @staticmethod
    def backward(ctx, g, _):
        gs = ordered_sum(ctx.group.all_gather(g.cpu() if ctx.hop else g))
        return torch.zeros(()), gs.to(ctx.device), None


class _RankSum:
    """The differentiable sum over the ranks one forward's batch norms
    take their statistics through."""

    def __init__(self, group):
        self.group = group
        self.token = torch.zeros(())

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        total, self.token = _GroupSum.apply(self.token, t, self.group)
        return total.to(t.device)


class ShardedTrainStep(TrainStep):
    """``TrainStep`` over the data axes of a mesh with ZeRO stages
    (reference ``:89``).

    Args beyond TrainStep:
      mesh: the mesh (the active one by default).
      data_axes: mesh axes the batch dim is split over (``dp`` and
        ``sharding`` where of size > 1, as the reference, whose sharding
        group is also a data group).
      sharding_stage: 0 none, 1 optimizer states, 2 + gradient
        reduce-scatter, 3 + parameters.
      recompute: the whole loss one recompute region (``jit.TrainStep``).
    """

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 data_axes=None, sharding_stage: int = 0,
                 recompute: bool = False, input_specs=None, **kwargs):
        super().__init__(model, loss_fn, optimizer, recompute=recompute,
                         **kwargs)
        self.mesh = mesh or get_mesh()
        require_no_model_parallel(self.mesh, "ShardedTrainStep")
        self.input_specs = (None if input_specs is None
                            else [tuple(s or ()) for s in input_specs])
        self._mp = self.mesh.shape.get("mp", 1)
        self._sp = self.mesh.shape.get("sp", 1)
        self._pp = self.mesh.shape.get("pp", 1)
        if self._mp > 1 or self._sp > 1 or self._pp > 1:
            self._model_parallel(model, optimizer, recompute)
        # the sp ranks of a model that splits the sequence hold partial
        # gradients; any other model's sp ranks are replicas
        self._spgroup = (self.mesh.axis_group("sp") if self._sp > 1 and any(
            getattr(m, "splits_sequence", False) for m in model.modules())
            else None)
        if sharding_stage not in (0, 1, 2, 3):
            raise ValueError(f"sharding_stage must be 0-3, got "
                             f"{sharding_stage!r}")
        if data_axes is None:
            data_axes = tuple(a for a in ("dp", "sharding")
                              if self.mesh.shape.get(a, 1) > 1) or None
        self.data_axes = data_axes
        self.sharding_stage = sharding_stage
        mesh = self.mesh
        self.zero_axis = ("sharding" if mesh.shape.get("sharding", 1) > 1
                          else "dp")
        self._nd = mesh.axis_size(data_axes) if data_axes else 1
        if recompute and self._nd > 1 and in_loopback() and any(
                p.is_cuda for p in model.parameters()) and any(
                isinstance(m, _BatchNormBase) for m in model.modules()):
            raise NotImplementedError(
                "ShardedTrainStep(recompute=True) on LoopbackWorld ranks on "
                "the card cannot replay the batch norms' sums over the "
                "ranks: run without recompute, or one rank a process")
        self._dgroup = mesh.axis_group(data_axes) if self._nd > 1 else None
        self._zgroup = (mesh.axis_group(self.zero_axis)
                        if sharding_stage >= 1 else None)
        self._nz = self._zgroup.size if self._zgroup is not None else 1
        self._owner = None
        if sharding_stage >= 2 and self._nd > 1 and self.zero_axis in \
                mesh.axes_of(data_axes):
            topo = HybridTopology(mesh)
            self._owner = [topo.axis_rank(r, self.zero_axis)
                           for r in topo.group_ranks(mesh.rank,
                                                     mesh.axes_of(data_axes))]
        if sharding_stage >= 1 and self._nz > 1 and type(
                optimizer).__name__ in ("Lamb", "LarsMomentum"):
            raise TypeError(
                f"ShardedTrainStep cannot shard the state of a norm-per-"
                f"parameter optimizer ({type(optimizer).__name__}) over "
                f"{self._nz} ranks: its trust ratios would be taken over "
                "chunks.  Use sharding_stage=0.")
        self._specs = None
        self._pshards: Dict[str, torch.Tensor] = {}
        self._shapes: Dict[str, torch.Size] = {}

    def _model_parallel(self, model, optimizer, recompute):
        """Hand the mesh to the mp-aware modules, then refuse what the
        step cannot split."""
        mesh = self.mesh
        for m in model.modules():
            if hasattr(m, "apply_mesh"):
                m.apply_mesh(mesh)
        if self._mp > 1:
            for n, p in model.named_parameters():
                attr = getattr(p, "dist_attr", None)
                axes = [] if attr is None else [
                    a for e in attr.sharding(mesh) if e is not None
                    for a in ((e,) if isinstance(e, str) else e)]
                if "mp" in axes and getattr(p, "mp_split", None) is None:
                    raise NotImplementedError(
                        f"parameter {n!r} carries {attr} over mp="
                        f"{self._mp}, but no mp-aware layer or model holds "
                        "it in shards; the step does not keep it whole")
        clip = getattr(optimizer, "_grad_clip", None)
        if (self._mp > 1 or self._pp > 1) and clip is not None and \
                type(clip).__name__ != "ClipGradByValue":
            raise NotImplementedError(
                f"{type(clip).__name__} at mp={self._mp}, pp={self._pp} "
                "would take its norms over this rank's shards or stage: "
                "not ported")
        if recompute and in_loopback() and any(
                p.is_cuda for p in model.parameters()):
            raise NotImplementedError(
                "ShardedTrainStep(recompute=True) at mp, sp or pp > 1 on "
                "LoopbackWorld ranks on the card cannot replay the ranks' "
                "sums: run without recompute, or one rank a process")

    # -- the rank's part of the batch ---------------------------------------
    def _slice_spec(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's part of an input by its ``input_specs`` entry, in
        each of the ``accumulate_steps`` micro-batches."""
        if t.dim() == 0:
            return t
        if len(spec) > t.dim():
            raise ValueError(f"input spec {spec} is longer than the input's "
                             f"{t.dim()} dims")
        micro = self.accumulate_steps
        if micro == 1:
            return _local_slice(t, spec, self.mesh)
        m = t.reshape((micro, -1) + tuple(t.shape[1:]))
        parts = [_local_slice(m[k], spec, self.mesh) for k in range(micro)]
        return torch.cat(parts, 0)

    def _slice(self, t: torch.Tensor, spec=None) -> torch.Tensor:
        """This rank's slice of each of the ``accumulate_steps``
        micro-batches of a global-batch input (reference ``:151-157``)."""
        if spec is not None:
            return self._slice_spec(t, spec)
        if t.dim() == 0 or self._nd == 1:
            return t
        micro, nd = self.accumulate_steps, self._nd
        if t.shape[0] % (micro * nd):
            raise ValueError(
                f"global batch {t.shape[0]} is not divisible by "
                f"{micro} micro-batches x {nd} data ranks")
        rest = tuple(t.shape[1:])
        return t.reshape((micro, nd, -1) + rest)[:, self._dgroup.rank
                                                 ].reshape((-1,) + rest)

    def _stats(self):
        if self._nd == 1:
            return contextlib.nullcontext()
        return batch_stats_over(_RankSum(self._dgroup), self._nd)

    def _mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data ranks (``zero``'s f32 leg), in t's
        dtype."""
        if self._nd == 1:
            return t
        return mean_over(self._dgroup, t).to(t.dtype)

    def _reduce_scatter(self, gflat: torch.Tensor) -> torch.Tensor:
        """The mean over the data ranks of this rank's chunk of a padded
        flat gradient, summed in rank order as ``_mean`` sums it: each
        data rank sends every other the chunk its zero index owns (the
        all-to-all of ``zero``'s f32 reduce-scatter, in the gradient's
        accumulation dtype)."""
        acc = torch.promote_types(gflat.dtype, torch.float32)
        chunks = gflat.to(acc).reshape(max(self._owner) + 1, -1)
        return ordered_sum(self._dgroup.all_to_all(chunks[self._owner])
                           ) / self._nd

    # -- the sharded optimizer state ----------------------------------------
    def _ensure_state(self, params: dict):
        if self.sharding_stage == 0 or self._opt_states is not None:
            return
        self._specs = build_shard_specs(params, self._nz, chunk=1)
        self._opt_states = init_state_shards(self.optimizer, params,
                                             self._specs, self._zgroup.rank)

    def opt_state_bytes_per_replica(self) -> int:
        """Bytes of optimizer state this rank holds (its chunks of the
        elementwise slots at stage >= 1, the scalars whole)."""
        params = self._params()
        if self._opt_states is None:
            if self.sharding_stage == 0:
                self._opt_states = self.optimizer.functional_init_states(
                    {n: p.detach() for n, p in params.items()})
            else:
                self._ensure_state(params)
        return sum(v.numel() * v.element_size()
                   for slots in self._opt_states.values()
                   for v in slots.values())

    def _chunk(self, t: torch.Tensor, n: str) -> torch.Tensor:
        spec = self._specs[n]
        z = self._zgroup.rank
        return F.pad(t.reshape(-1), (0, spec.padded - spec.size))[
            z * spec.shard_len:(z + 1) * spec.shard_len]

    # -- stage 3: parameters as chunks between steps ------------------------
    def _release_params(self):
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                if p.requires_grad and p.numel():
                    self._shapes[n] = p.shape
                    self._pshards[n] = self._chunk(p.detach(), n).clone()
                    p.data = p.data.new_empty(0)

    def gather_params(self) -> dict:
        """All-gather stage 3's chunks back into the module, then return
        {name: the reference's full tensor}: a parameter split over ``mp``
        all-gathered and assembled (GPT's ``qkv`` head permutation undone),
        one split over ``pp`` concatenated over the stages, the others as
        they are.  Every rank calls it."""
        self._gather_chunks()
        group = self.mesh.axis_group("mp") if self._mp > 1 else None
        with torch.no_grad():
            full = tp.full_parameters(self.model, group)
            if self._pp > 1:
                full = full_stages(self.model, full,
                                   self.mesh.axis_group("pp"))
            return full

    def _gather_chunks(self):
        """All-gather the parameters' chunks back into the module (every
        rank calls it); a no-op unless stage 3 holds chunks."""
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                if n in self._pshards:
                    full = f32_all_gather(self._pshards.pop(n), self._zgroup)
                    size = self._specs[n].size
                    p.data = full[:size].reshape(self._shapes[n])

    # -- the step -----------------------------------------------------------
    def _run(self, inputs, steps, what, unroll=False):
        self._ensure_state(self._params())
        self._gather_chunks()
        try:
            return super()._run(inputs, steps, what, unroll)
        finally:
            if self.sharding_stage == 3:
                self._release_params()

    def _numerics(self, grads: dict, before: dict, after: dict, loss,
                  chunked: bool) -> dict:
        """The step's numerics aux (``FLAGS_numerics``, reference
        ``:161-176``): each rank's :func:`numerics.compute_aux` of its
        pieces, summed over ``mp`` for the leaves split there, over
        ``pp`` for the stacked layers, and over the ZeRO group for the
        chunks (``chunked``), so every rank holds the reference's
        replicated record."""
        aux = numerics.compute_aux(grads, before, after, loss)
        names = sorted(grads)
        params = dict(self.model.named_parameters())
        axes = []
        if self._mp > 1:
            axes.append((self.mesh.axis_group("mp"), [
                getattr(params[n], "mp_split", None) is not None
                for n in names]))
        if self._pp > 1:
            axes.append((self.mesh.axis_group("pp"), [
                getattr(params[n], "pp_split", None) is not None
                for n in names]))
        if chunked:
            axes.append((self._zgroup, [True] * len(names)))
        return numerics.sum_aux_over(aux, axes)

    def _one_step(self, params: dict, inputs, lr, states,
                  numerics_aux: bool = False):
        micro = self.accumulate_steps
        specs = self.input_specs or [None] * len(inputs)
        if len(specs) != len(inputs):
            raise ValueError(f"{len(specs)} input_specs for {len(inputs)} "
                             "inputs")
        parts = [self._slice(i, s) for i, s in zip(inputs, specs)]
        parts = [p if p.dim() == 0 else p.reshape(
            (micro, -1) + tuple(p.shape[1:])) for p in parts]
        losses, grads = [], None
        for k in range(micro):
            with self._stats():
                loss_k, g_k = loss_and_grads(
                    self._loss_from, params,
                    [p if p.dim() == 0 else p[k] for p in parts])
            losses.append(loss_k)
            grads = g_k if grads is None else {
                n: grads[n] + g_k[n] for n in grads}
        if micro > 1:
            grads = {n: g / micro for n, g in grads.items()}
        with torch.no_grad(), torch.profiler.record_function(
                "TrainStep.update"):
            if self._spgroup is not None:
                grads = {n: sum_over(self._spgroup, g)
                         for n, g in grads.items()}
            loss = self._mean(torch.stack(losses)).mean()
            if self.sharding_stage == 0:
                grads = {n: self._mean(g) for n, g in grads.items()}
                before = {n: p.detach() for n, p in params.items()}
                if numerics_aux and self.donate:
                    before = {n: t.clone() for n, t in before.items()}
                new_params, states = apply_functional_update(
                    self.optimizer, grads,
                    {n: p.detach() for n, p in params.items()}, states, lr,
                    donate=self.donate)
                if numerics_aux:
                    return loss, new_params, states, self._numerics(
                        grads, before, new_params, loss, chunked=False)
                return loss, new_params, states
            gshards, pshards = {}, {}
            for n, p in params.items():
                g = grads.pop(n)
                spec = self._specs[n]
                if self._owner is not None:
                    gflat = F.pad(g.reshape(-1), (0, spec.padded - spec.size))
                    gshards[n] = self._reduce_scatter(gflat).to(g.dtype)
                else:
                    gshards[n] = self._chunk(self._mean(g), n)
                pshards[n] = self._chunk(p.detach(), n)
            before = ({n: t.clone() for n, t in pshards.items()}
                      if numerics_aux and self.donate else pshards)
            new_shards, states = self.optimizer.functional_update(
                pshards, sharded_clip(self.optimizer, gshards, self._zgroup),
                states, lr=lr, donate=self.donate)
            new_params = {
                n: f32_all_gather(new_shards[n].to(p.dtype), self._zgroup)[
                    :self._specs[n].size].view_as(p)
                for n, p in params.items()}
            if numerics_aux:
                return loss, new_params, states, self._numerics(
                    gshards, before, new_shards, loss, chunked=True)
        return loss, new_params, states

    def lower_hlo(self, *inputs):
        raise NotImplementedError(
            "ShardedTrainStep.lower_hlo is the reference's XLA text, not "
            "ported (ROADMAP Queue 1 item 8)")
