"""The data-parallel mesh over torch.distributed (port of the ``dp`` part
of paddle_tpu/parallel/mesh.py and dp_meta.py ``_require_pure_dp``).

The reference names a mesh of devices and lets ``shard_map`` place one
replica on each; here each replica is a process (a rank), and a
:class:`Mesh` is the dp axis size with the group that its collectives run
over.  The steps of ``parallel/zero.py`` and ``parallel/dp_meta.py`` use
three primitives of that group:

- ``all_to_all(x)``: x (n, ...) -> out (n, ...) with ``out[j]`` rank j's
  ``x[rank]``;
- ``all_gather(x)``: x (...) -> (n, ...), rank j's x at j;
- ``ring_shift(bufs)``: send each tensor to rank + 1 and receive the same
  shapes from rank - 1, one neighbour hop.

:class:`DistGroup` runs them over a ``torch.distributed`` process group
(the default group unless one is given): NCCL for a model on the card,
gloo for ``device="cpu"`` (:func:`init_process_group` picks the backend).
:class:`LoopbackWorld` runs n ranks as threads of one process, each rank
on its own replica, with the same primitives by exchange in memory: the
way to run dp >= 2 on a machine with one card, where NCCL refuses two
ranks on one device.

Only the ``dp`` axis is ported: a mesh with another axis of size > 1
raises (mesh shardings, pipeline and sequence parallelism come later).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "DistGroup", "LoopbackWorld", "make_mesh", "set_mesh",
           "get_mesh", "init_process_group"]


class DistGroup:
    """The three collective primitives over a torch.distributed group."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialised: call "
                "parallel.init_process_group (or torch.distributed."
                "init_process_group) first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((self.size,) + tuple(x.shape))
        dist.all_gather_into_tensor(out.view(-1), x.contiguous().view(-1),
                                    group=self.group)
        return out

    def ring_shift(self, bufs) -> List[torch.Tensor]:
        nxt = (self.rank + 1) % self.size
        prv = (self.rank - 1) % self.size
        recv = [torch.empty_like(b) for b in bufs]
        ops = ([dist.P2POp(dist.isend, b.contiguous(), nxt, self.group)
                for b in bufs]
               + [dist.P2POp(dist.irecv, r, prv, self.group) for r in recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv


class LoopbackWorld:
    """``n`` ranks in one process: :meth:`run` calls ``fn(rank, mesh)`` on
    n threads and returns their results in rank order.  The collectives
    meet at a barrier and exchange tensors by reference, on the one device
    all ranks share (work on one CUDA stream stays in its order).  A rank
    that raises breaks the barrier, so the others raise too, and the first
    error is re-raised."""

    def __init__(self, n: int, timeout: float = 600.0):
        self.n = int(n)
        self._slots: list = [None] * self.n
        self._barrier = threading.Barrier(self.n, timeout=timeout)

    def _exchange(self, rank: int, obj) -> list:
        self._slots[rank] = obj
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()              # every rank has read the slots
        return got

    def run(self, fn: Callable) -> list:
        results: list = [None] * self.n
        errors: list = [None] * self.n

        def body(rank):
            try:
                results[rank] = fn(rank, Mesh({"dp": self.n},
                                              _LoopbackGroup(self, rank)))
            except BaseException as e:    # noqa: BLE001 - re-raised below
                errors[rank] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"dp-rank-{r}")
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = next((e for e in errors
                      if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return results


class _LoopbackGroup:
    def __init__(self, world: LoopbackWorld, rank: int):
        self.world = world
        self.rank = rank
        self.size = world.n

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        got = self.world._exchange(self.rank, x)
        return torch.stack([got[j][self.rank] for j in range(self.size)])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self.world._exchange(self.rank, x))

    def ring_shift(self, bufs) -> List[torch.Tensor]:
        got = self.world._exchange(self.rank, list(bufs))
        return [b.clone() for b in got[(self.rank - 1) % self.size]]


class Mesh:
    """A data-parallel mesh: ``shape`` ({"dp": n}) and ``group``, the
    collectives of this rank (``rank``) among the n."""

    def __init__(self, shape: Dict[str, int], group):
        self.shape = dict(shape)
        self.group = group
        if group.size != self.shape.get("dp", 1):
            raise ValueError(f"mesh dp={self.shape.get('dp', 1)} does not "
                             f"match the group's {group.size} ranks")

    @property
    def rank(self) -> int:
        return self.group.rank

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def _require_pure_dp(mesh: Mesh, who: str = "this strategy"):
    """Raise unless ``dp`` is the mesh's only axis of size > 1 (reference
    dp_meta.py:45)."""
    extra = {a: s for a, s in mesh.shape.items() if a != "dp" and s > 1}
    if extra:
        raise ValueError(
            f"{who} is a pure data-parallel strategy (as in the reference "
            f"meta-opt DAG); mesh also has {extra}")


def init_process_group(device="cuda", *, rank: int, world_size: int,
                       init_method: str):
    """``torch.distributed.init_process_group`` with the backend of the
    model's device: NCCL for ``"cuda"`` (after selecting the card
    ``rank % device_count``), gloo for ``"cpu"``.  ``init_method`` is an
    address such as ``tcp://localhost:<port>``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def make_mesh(axes: Dict[str, int], group=None) -> Mesh:
    """A dp mesh over ``group`` (a torch.distributed group, the default
    one when None); ``{"dp": -1}`` takes the group's size.  Axes other
    than ``dp`` of size > 1 are not ported and raise."""
    extra = {a: s for a, s in axes.items() if a != "dp" and s != 1}
    if extra:
        raise NotImplementedError(
            f"mesh axes {extra}: only the dp axis is ported")
    g = DistGroup(group)
    dp = axes.get("dp", -1)
    return Mesh({"dp": g.size if dp == -1 else int(dp)}, g)


_global_mesh: Optional[Mesh] = None


def set_mesh(mesh: Mesh) -> Mesh:
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_mesh() -> Mesh:
    """The active mesh; by default a dp mesh over the whole default
    group."""
    global _global_mesh
    if _global_mesh is None:
        _global_mesh = make_mesh({"dp": -1})
    return _global_mesh
