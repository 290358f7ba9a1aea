"""``CommunicateTopology`` and ``HybridCommunicateGroup`` (port of
paddle_tpu/distributed/fleet/topology.py): this rank's place in the mesh
and the collective groups along its axes (``collective.new_group(axis=)``
over the mesh's process subgroups)."""
from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.distributed.collective import Group, new_group
from paddle_tpu_torch.parallel.mesh import HybridTopology, get_mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, axis_name):
        return self._dims[self._names.index(axis_name)]

    def world_size(self):
        n = 1
        for d in self._dims:
            n *= d
        return n


_AXIS_ALIAS = {"data": "dp", "pipe": "pp", "model": "mp",
               "sharding": "sharding", "sep": "sp"}


class HybridCommunicateGroup:
    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 mesh=None):
        self._mesh = mesh or get_mesh()
        self._topo = HybridTopology(self._mesh)
        self._rank = self._mesh.rank
        self._groups = {}

    def _axis(self, name: str) -> str:
        return _AXIS_ALIAS.get(name, name)

    def _group_for(self, name: str) -> Group:
        axis = self._axis(name)
        if axis not in self._groups:
            self._groups[axis] = new_group(axis=axis)
        return self._groups[axis]

    # degrees
    def get_data_parallel_world_size(self):
        return self._topo.get_degree("dp")

    def get_model_parallel_world_size(self):
        return self._topo.get_degree("mp")

    def get_pipe_parallel_world_size(self):
        return self._topo.get_degree("pp")

    def get_sharding_parallel_world_size(self):
        return self._topo.get_degree("sharding")

    # this rank's coordinates
    def get_data_parallel_rank(self):
        return self._topo.axis_rank(self._rank, "dp")

    def get_model_parallel_rank(self):
        return self._topo.axis_rank(self._rank, "mp")

    def get_stage_id(self):
        return self._topo.axis_rank(self._rank, "pp")

    def get_sharding_parallel_rank(self):
        return self._topo.axis_rank(self._rank, "sharding")

    # groups
    def get_data_parallel_group(self) -> Group:
        return self._group_for("data")

    def get_model_parallel_group(self) -> Group:
        return self._group_for("model")

    def get_pipe_parallel_group(self) -> Group:
        return self._group_for("pipe")

    def get_sharding_parallel_group(self) -> Group:
        return self._group_for("sharding")

    def get_check_parallel_group(self) -> Group:
        return self._group_for("data")

    def get_data_parallel_group_src_rank(self):
        return self._topo.group_ranks(self._rank, "dp")[0] if (
            "dp" in self._mesh.axis_names) else 0

    def topology(self):
        return self._topo
