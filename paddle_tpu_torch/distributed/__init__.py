"""``paddle.distributed`` of the port (paddle_tpu/distributed/
__init__.py): the collective API over the mesh's groups
(``collective.py``), ``ParallelEnv``, ``init_parallel_env`` and
``DataParallel`` (``parallel.py``), ``spawn``, ``fleet`` in collective
mode, the wire codecs of the collectives (``wire.py``), ``split`` and
the tensor-parallel layers (``tp_layers.py``), the parameter server
``ps`` (its tiers, TCP transport ``ps.service`` and graph table
``ps.graph``) and its datasets (``dataset.py``: ``DatasetFactory``,
``QueueDataset``, ``InMemoryDataset``, ``train_from_dataset``), the
sharded checkpoints (``checkpoint``) and their generations
(``durable``), elastic training (``elastic``: the rendezvous stores, the
agent, ``reform``) and the launcher (``launch``), both loaded at first
use."""
from paddle_tpu_torch.distributed.collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_reduce, alltoall, barrier, broadcast,
    destroy_process_group, get_group, get_rank, get_world_size,
    is_initialized, new_group, p2p_shift, recv, reduce, reduce_scatter,
    scatter, send, split, wait)
from paddle_tpu_torch.distributed.parallel import (  # noqa: F401
    DataParallel, ParallelEnv, init_parallel_env)
from paddle_tpu_torch.distributed.spawn import spawn  # noqa: F401
from paddle_tpu_torch.distributed import fleet  # noqa: F401
from paddle_tpu_torch.distributed import ps  # noqa: F401
from paddle_tpu_torch.distributed.dataset import (  # noqa: F401
    DatasetFactory, InMemoryDataset, QueueDataset, train_from_dataset)
from paddle_tpu_torch.distributed import checkpoint  # noqa: F401
from paddle_tpu_torch.distributed.tp_layers import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    mark_sharding)

shard_tensor = mark_sharding


def __getattr__(name):
    # the launcher's plain path imports nothing of the framework: neither
    # it nor elastic is imported with the package
    if name in ("elastic", "launch"):
        import importlib
        return importlib.import_module(f"paddle_tpu_torch.distributed.{name}")
    raise AttributeError(
        f"module 'paddle_tpu_torch.distributed' has no attribute {name!r}")

__all__ = [
    "init_parallel_env", "ParallelEnv", "DataParallel", "spawn",
    "get_rank", "get_world_size", "is_initialized", "new_group", "get_group",
    "destroy_process_group", "Group", "ReduceOp", "all_reduce", "all_gather",
    "broadcast", "reduce", "scatter", "reduce_scatter", "alltoall",
    "barrier", "send", "recv", "wait", "split", "fleet", "ps",
    "shard_tensor",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
]
