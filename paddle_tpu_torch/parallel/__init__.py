"""Parallelism of the port (paddle_tpu/parallel): the named mesh over
torch.distributed (or ``LoopbackWorld`` threads) and its topology, the
data-parallel steps (``ShardedTrainStep`` over ``dp`` and ``sharding``
with ZeRO stages 0-3; LocalSGD, DGC and the compressed all-reduce in
``dp_meta``; the ZeRO sharded weight update with quantized wires in
``zero``) and the quantized ring collectives; tensor parallelism's
primitives (``tp``), ring attention over ``sp`` (``ring_attention``) and
``shard_map_compat``; the pipeline's schedules over ``pp``
(``pipeline``: ``pipeline_forward`` F-then-B, ``make_pipeline_train_1f1b``).
``parity``: the replica-parity probe (``FLAGS_replica_parity``)."""
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
from paddle_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_train_1f1b, pipeline_forward)
from paddle_tpu_torch.parallel import parity  # noqa: F401
