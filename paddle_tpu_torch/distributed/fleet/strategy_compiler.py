"""The strategy compiler: a ``DistributedStrategy`` to one train step
(port of paddle_tpu/distributed/fleet/strategy_compiler.py).

Each of the reference's meta-optimizers is a knob of the step fleet
builds, and compiling a strategy resolves the knobs, the mesh axes and
the chain of meta-optimizers that fired (``applied_meta_list``, in the
reference's order: AMP, Recompute, Sharding, Pipeline, GradientMerge,
(Adaptive)LocalSGD, DGC, Lamb, Lars, FP16AllReduce, then
GraphExecution for plain data parallelism).  The mesh axes come from
``hybrid_configs`` and ``sharding_configs`` against the world's size
(``:86-117``); every conflict the reference refuses raises here
(``:157-200``).  ``train_step`` builds ``LocalSGDTrainStep``,
``DGCTrainStep`` or ``CompressedAllReduceTrainStep`` for the
strategies that own the gradient exchange and ``ShardedTrainStep``
otherwise; ``maybe_swap_optimizer`` puts ``Lamb`` or ``LarsMomentum`` in
place of the user's optimizer for the lamb and lars switches.

A strategy's ``mp_degree`` gives the mesh an ``mp`` axis, and the step is
``ShardedTrainStep`` over it (tensor parallelism: the model must be
mp-aware, as ``GPT`` and the layers of ``distributed/tp_layers.py`` are);
a ``pp_degree`` > 1 a ``pp`` axis, outermost (the pipeline: ``GPT`` holds
its stage), and ``strategy.pipeline`` with ``pipeline_configs`` sets the
model's ``schedule_mode`` in ``train_step`` ("1F1B" or "1" -> 1, else 0,
reference ``:44-52``) and raises ``accumulate_steps`` to theirs.  Where
the reference runs a sub-mesh over fewer devices than it has, the port's
ranks each hold a replica and the degrees must lay out the whole world.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from paddle_tpu_torch.distributed.fleet.strategy import DistributedStrategy
from paddle_tpu_torch.parallel.mesh import make_mesh

__all__ = ["compile_strategy", "CompiledStrategy", "maybe_swap_optimizer"]


class CompiledStrategy:
    def __init__(self, strategy: DistributedStrategy, mesh,
                 applied_meta_list: List[str], step_kwargs: dict,
                 optimizer_swap: Optional[str],
                 skipped_meta_list: Optional[List[Tuple[str, str]]] = None):
        self.strategy = strategy
        self.mesh = mesh
        self.applied_meta_list = applied_meta_list
        self.skipped_meta_list = skipped_meta_list or []
        self.step_kwargs = step_kwargs
        self.optimizer_swap = optimizer_swap  # 'lamb' | 'lars' | None

    def train_step(self, model, loss_fn, optimizer, **overrides):
        optimizer = maybe_swap_optimizer(optimizer, self)
        kwargs = dict(self.step_kwargs)
        kwargs.update(overrides)
        if self.strategy.pipeline and hasattr(
                getattr(model, "config", None), "schedule_mode"):
            # the pipeline's schedule reaches the model (the reference's
            # section_worker schedule_mode, set by pipeline_configs)
            mode = self.strategy.pipeline_configs.get("schedule_mode",
                                                      "1F1B")
            model.config.schedule_mode = 1 if str(mode).upper() in (
                "1F1B", "1") else 0
        dp_meta_kw = {k: v for k, v in kwargs.items()
                      if k in ("amp_level", "amp_dtype", "recompute")}
        if "LocalSGDOptimizer" in self.applied_meta_list or \
                "AdaptiveLocalSGDOptimizer" in self.applied_meta_list:
            from paddle_tpu_torch.parallel.dp_meta import LocalSGDTrainStep
            adaptive = "AdaptiveLocalSGDOptimizer" in self.applied_meta_list
            cfg = (self.strategy.adaptive_localsgd_configs if adaptive
                   else self.strategy.localsgd_configs)
            k = cfg.get("init_k_steps" if adaptive else "k_steps", 4)
            return LocalSGDTrainStep(
                model, loss_fn, optimizer, mesh=self.mesh,
                k_steps=max(1, k), begin_step=cfg.get("begin_step", 1),
                adaptive=adaptive, **dp_meta_kw)
        if "DGCOptimizer" in self.applied_meta_list:
            from paddle_tpu_torch.parallel.dp_meta import DGCTrainStep
            cfg = self.strategy.dgc_configs
            return DGCTrainStep(
                model, loss_fn, optimizer, mesh=self.mesh,
                momentum=cfg.get("momentum", 0.9),
                sparsity=cfg.get("sparsity", [0.999]),
                rampup_begin_step=cfg.get("rampup_begin_step", 0),
                rampup_step=cfg.get("rampup_step", 1), **dp_meta_kw)
        if "FP16AllReduceOptimizer" in self.applied_meta_list:
            from paddle_tpu_torch.parallel.dp_meta import (
                CompressedAllReduceTrainStep)
            return CompressedAllReduceTrainStep(
                model, loss_fn, optimizer, mesh=self.mesh, **dp_meta_kw)
        from paddle_tpu_torch.parallel.sharded import ShardedTrainStep
        return ShardedTrainStep(model, loss_fn, optimizer, mesh=self.mesh,
                                **kwargs)


def _mesh_axes_from(strategy: DistributedStrategy, n_devices: int) -> dict:
    """The mesh axes of the strategy's degrees over ``n_devices`` ranks
    (reference ``:86-117``)."""
    hy = strategy.hybrid_configs
    mp = hy.get("mp_degree", 1)
    pp = hy.get("pp_degree", 1)
    sh = hy.get("sharding_degree", 1)
    dp = hy.get("dp_degree", -1)
    if strategy.sharding:
        sc = strategy.sharding_configs
        mp = max(mp, sc.get("mp_degree", 1))
        pp = max(pp, sc.get("pp_degree", 1))
        sh = max(sh, sc.get("sharding_degree", 1))
        if sc.get("dp_degree", 1) != 1:
            dp = sc["dp_degree"]
    fixed = mp * pp * sh
    if dp == -1:
        if n_devices % fixed:
            raise ValueError(
                f"hybrid degrees mp={mp}×pp={pp}×sharding={sh} do not "
                f"divide {n_devices} devices")
        dp = max(1, n_devices // fixed)
    elif fixed * dp > n_devices:
        raise ValueError(
            f"hybrid degrees dp={dp}×mp={mp}×pp={pp}×sharding={sh} "
            f"exceed {n_devices} devices")
    axes = {}
    for name, size in (("pp", pp), ("dp", dp), ("sharding", sh),
                       ("mp", mp)):
        if size > 1:
            axes[name] = size
    return axes or {"dp": n_devices}


def _world_size(devices) -> int:
    if devices is None:
        from paddle_tpu_torch.distributed.collective import get_world_size
        return get_world_size()
    return devices if isinstance(devices, int) else len(devices)


def compile_strategy(strategy: Optional[DistributedStrategy],
                     devices=None) -> CompiledStrategy:
    """The strategy resolved over ``devices`` ranks (a count or a list;
    this rank's world when None), its mesh made over the world."""
    strategy = strategy or DistributedStrategy()
    axes = _mesh_axes_from(strategy, _world_size(devices))
    mesh = make_mesh(axes)

    applied: List[str] = []
    kw: dict = {}
    optimizer_swap = None

    if strategy.amp:
        applied.append("AMPOptimizer")
        cfg = strategy.amp_configs
        kw["amp_level"] = "O2" if cfg.get("use_pure_fp16") else "O1"
        kw["amp_dtype"] = "bfloat16" if cfg.get("use_bf16", True) else (
            "float16")
    if strategy.recompute:
        applied.append("RecomputeOptimizer")
        kw["recompute"] = True
    if strategy.sharding:
        applied.append("ShardingOptimizer")
        kw["sharding_stage"] = strategy.sharding_configs.get("stage", 1)
        acc = strategy.sharding_configs.get("gradient_merge_acc_step", 1)
        if acc > 1:
            kw["accumulate_steps"] = acc
    if strategy.pipeline:
        applied.append("PipelineOptimizer")
        kw["accumulate_steps"] = max(
            kw.get("accumulate_steps", 1),
            strategy.pipeline_configs.get("accumulate_steps", 1))
    if strategy.gradient_merge:
        applied.append("GradientMergeOptimizer")
        kw["accumulate_steps"] = max(
            kw.get("accumulate_steps", 1),
            strategy.gradient_merge_configs.get("k_steps", 1))
    skipped: List[Tuple[str, str]] = []
    pure_dp_conflicts = [m for m in applied if m in (
        "ShardingOptimizer", "PipelineOptimizer", "GradientMergeOptimizer")]
    if strategy.localsgd or strategy.adaptive_localsgd:
        name = ("AdaptiveLocalSGDOptimizer" if strategy.adaptive_localsgd
                else "LocalSGDOptimizer")
        if pure_dp_conflicts:
            raise ValueError(
                f"{name} is a pure data-parallel strategy and cannot "
                f"compose with {pure_dp_conflicts} (matches the reference "
                f"meta-optimizer exclusion DAG)")
        applied.append(name)
    if strategy.dgc:
        if pure_dp_conflicts:
            raise ValueError(
                f"DGCOptimizer is a pure data-parallel strategy and cannot "
                f"compose with {pure_dp_conflicts} (reference meta-opt DAG)")
        if strategy.localsgd or strategy.adaptive_localsgd:
            raise ValueError(
                "DGC compresses the gradient exchange; LocalSGD replaces "
                "it with parameter averaging — pick one")
        if strategy.fp16_allreduce:
            raise ValueError(
                "DGC and fp16_allreduce both own the gradient exchange — "
                "pick one")
        applied.append("DGCOptimizer")
    if strategy.lamb:
        applied.append("LambOptimizer")
        optimizer_swap = "lamb"
    if strategy.lars:
        applied.append("LarsOptimizer")
        optimizer_swap = "lars"
    if strategy.fp16_allreduce:
        if strategy.localsgd or strategy.adaptive_localsgd:
            raise ValueError(
                "fp16_allreduce composes with gradient allreduce; LocalSGD "
                "replaces it with parameter averaging — pick one")
        if pure_dp_conflicts:
            raise ValueError(
                f"FP16AllReduceOptimizer is pure data-parallel and cannot "
                f"compose with {pure_dp_conflicts}")
        applied.append("FP16AllReduceOptimizer")
    owns_dp_comm = any(m in applied for m in (
        "LocalSGDOptimizer", "AdaptiveLocalSGDOptimizer",
        "FP16AllReduceOptimizer", "DGCOptimizer"))
    if (mesh.shape.get("dp", 1) > 1 and not owns_dp_comm) \
            or len(applied) == 0:
        applied.append("GraphExecutionOptimizer")  # plain dp allreduce tier

    return CompiledStrategy(strategy, mesh, applied, kw, optimizer_swap,
                            skipped_meta_list=skipped)


def maybe_swap_optimizer(optimizer, compiled: CompiledStrategy):
    """The LAMB / LARS meta-optimizers replace the inner optimizer
    (reference ``:204-234``)."""
    from paddle_tpu_torch import optimizer as opt_mod
    if compiled.optimizer_swap == "lamb" and not isinstance(
            optimizer, opt_mod.Lamb):
        cfg = compiled.strategy.lamb_configs
        return opt_mod.Lamb(
            learning_rate=optimizer.get_lr(),
            lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
            parameters=optimizer._parameter_list)
    if compiled.optimizer_swap == "lars" and not isinstance(
            optimizer, opt_mod.LarsMomentum):
        cfg = compiled.strategy.lars_configs
        return opt_mod.LarsMomentum(
            learning_rate=optimizer.get_lr(),
            momentum=getattr(optimizer, "_momentum", 0.9),
            lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            epsilon=cfg.get("epsilon", 1e-9),
            parameters=optimizer._parameter_list)
    return optimizer
