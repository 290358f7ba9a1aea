"""The process environment and ``DataParallel`` (port of
paddle_tpu/distributed/parallel.py :1-179).

``ParallelEnv`` reads the ``PADDLE_*`` launch protocol
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``FLAGS_selected_gpus``).  ``init_parallel_env`` starts
``torch.distributed`` from it: NCCL on the card, gloo when the caller
asks for the CPU (``device="cpu"``), with the first trainer endpoint as
the rendezvous (``tcp://<endpoint>``) where the reference bootstraps
``jax.distributed``; a world of one rank with no endpoint takes a free
local port, so a lone process gets a one-rank group on the card.  It
then installs the mesh (``{"dp": world}`` unless ``mesh_axes`` names
others).  Inside a ``LoopbackWorld`` rank, or where a process group is
already up, it only installs the mesh.

``DataParallel`` wraps a layer and broadcasts rank 0's parameters and
buffers to every rank at construction (the reference's
``_sync_params_buffers``).  As in the reference, eager training through
it does not average gradients over the ranks at world size > 1:
``scale_loss``, ``apply_collective_grads`` and ``no_sync`` do nothing,
and gradients meet only inside the train steps (``ShardedTrainStep``,
the ``dp_meta`` steps) that fleet builds.
"""
from __future__ import annotations

import contextlib
import os
import socket
from typing import Optional

import torch.distributed as dist

from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.parallel import mesh as _mesh

__all__ = ["init_parallel_env", "ParallelEnv", "DataParallel",
           "get_rank", "get_world_size"]


def get_rank() -> int:
    from paddle_tpu_torch.distributed.collective import get_rank as _r
    return _r()


def get_world_size() -> int:
    from paddle_tpu_torch.distributed.collective import get_world_size as _w
    return _w()


class ParallelEnv:
    """The ``PADDLE_*`` environment (reference ``:50``), read at
    construction; this process's rank and world size where unset."""

    def __init__(self):
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", str(get_rank())))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM",
                                         str(get_world_size())))
        endpoints = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = endpoints.split(",") if endpoints else []
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
        self._device_id = int(os.getenv("FLAGS_selected_tpus",
                                        os.getenv("FLAGS_selected_gpus", "0")
                                        ).split(",")[0] or 0)

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def current_endpoint(self):
        return self._current_endpoint

    # legacy aliases
    local_rank = rank
    nranks = world_size
    dev_id = device_id


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_parallel_env(mesh_axes: Optional[dict] = None, device=None):
    """Start the process group from the ``PADDLE_*`` environment (NCCL,
    or gloo for ``device="cpu"``) unless one is up, then install the mesh
    of ``mesh_axes`` (``{"dp": world}`` by default).  Returns the
    :class:`ParallelEnv`."""
    env = ParallelEnv()
    if not _mesh.in_loopback() and not dist.is_initialized():
        if env.trainer_endpoints:
            addr = f"tcp://{env.trainer_endpoints[0]}"
        elif env.world_size == 1:
            addr = f"tcp://localhost:{_free_port()}"
        else:
            raise ValueError(
                f"init_parallel_env: a world of {env.world_size} ranks needs "
                "PADDLE_TRAINER_ENDPOINTS for its rendezvous")
        _mesh.init_process_group(device, rank=env.rank,
                                 world_size=env.world_size,
                                 init_method=addr)
    _mesh.set_mesh(_mesh.make_mesh(mesh_axes or {"dp": -1}))
    return env


class DataParallel(Layer):
    """Wraps ``layers`` for data-parallel training (reference ``:119``):
    rank 0's parameters and buffers are broadcast over the world (or
    ``group``) at construction.  ``comm_buffer_size`` and
    ``last_comm_buffer_size`` are accepted for the reference's API."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group
        self._sync_params_buffers()

    def _sync_params_buffers(self):
        """Rank 0's parameters and buffers on every rank (reference
        ``:131``)."""
        from paddle_tpu_torch.distributed.collective import (broadcast,
                                                             get_world_size)
        if get_world_size(self._group) <= 1:
            return
        for t in list(self._layers.parameters()) + list(
                self._layers.buffers()):
            broadcast(t, src=0, group=self._group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Pauses a gradient sync the eager loop never runs (reference
        ``:156``)."""
        yield

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    # the wrapped layer's names, without the wrapper's prefix
    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def parameters(self, *args, **kwargs):
        return self._layers.parameters(*args, **kwargs)
