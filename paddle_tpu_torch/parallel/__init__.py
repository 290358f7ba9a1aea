"""Data parallelism of the port (paddle_tpu/parallel): the dp mesh over
torch.distributed, the quantized ring collectives, the replicated
compressed all-reduce step and the ZeRO sharded weight update."""
from paddle_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, get_mesh, init_process_group, make_mesh, set_mesh)
