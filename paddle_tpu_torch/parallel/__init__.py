"""Parallelism of the port (paddle_tpu/parallel): the named mesh over
torch.distributed (or ``LoopbackWorld`` threads) and its topology, the
data-parallel steps (``ShardedTrainStep`` over ``dp`` and ``sharding``
with ZeRO stages 0-3; LocalSGD, DGC and the compressed all-reduce in
``dp_meta``; the ZeRO sharded weight update with quantized wires in
``zero``) and the quantized ring collectives; tensor parallelism's
primitives (``tp``), ring attention over ``sp`` (``ring_attention``) and
``shard_map_compat``.  The pipeline (``make_pipeline_train_1f1b``,
``pipeline_forward``, the ``pipeline`` submodule) is ROADMAP item 3c and
``parity`` item 6: each raises ``NotImplementedError`` naming its
item."""
from paddle_tpu_torch.parallel.mesh import (  # noqa: F401
    DistAttr, HybridTopology, LoopbackWorld, Mesh, auto_mesh, get_mesh,
    init_process_group, make_mesh, mesh_axis_size, set_mesh,
    shard_map_compat, shard_spec)
from paddle_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedTrainStep, shard_module)
from paddle_tpu_torch.parallel.dp_meta import (  # noqa: F401
    CompressedAllReduceTrainStep, DGCTrainStep, LocalSGDTrainStep)
from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep  # noqa: F401
from paddle_tpu_torch.parallel.ring_attention import ring_attention  # noqa: F401
from paddle_tpu_torch._pending import pending, pending_modules  # noqa: E402

make_pipeline_train_1f1b = pending("make_pipeline_train_1f1b", "3c",
                                   "pipeline parallelism")
pipeline_forward = pending("pipeline_forward", "3c", "pipeline parallelism")
__getattr__ = pending_modules("paddle_tpu_torch.parallel", {
    "pipeline": ("3c", "pipeline parallelism"),
    "parity": ("6", "the replica parity probe")})
