"""The collective communication API (port of paddle_tpu/distributed/
collective.py :38-430).

The reference's collectives run inside a parallel region (a ``shard_map``
trace over the mesh, where every shard calls them and gets its own
result) or eagerly across host processes.  Here every rank is a process
(or a ``LoopbackWorld`` thread) that calls them on its own tensors, so
they take the in-region meaning: each rank passes its tensor and gets
the reduction, the gathered list, its slice, as a shard of the
reference's region would.  They run over the active mesh's groups
(``parallel.mesh``): the whole world by default, the ranks along the
mesh axes a group names (``new_group(axis="dp")``), or a subset of ranks
(``new_group(ranks=[...])``).  In a lone process with no mesh and no
process group the world is this one rank, and each collective is what
it is over one rank (the reference's ``world_size == 1`` fast path).

Every reduction adds (or takes the max, min, product of) the ranks'
values in rank order, in the tensor's dtype: the same bits on every rank
and every backend.  A sum (``all_reduce`` and ``reduce`` with ``SUM`` or
``AVG``) is ``parallel.mesh.sum_over``, a reduce-scatter then an
all-gather, a ring all-reduce's traffic; ``MAX``, ``MIN`` and ``PROD``
all-gather the whole tensor, n copies of it a rank.  ``ReduceOp.PROD``
is the reference's in-region form, ``exp(sum log|x|)`` with the sign
from the count of negatives and 0 where any rank holds 0
(``:192-200``), not the eager ``prod``.
``reduce`` is ``all_reduce`` (every rank gets the value, ``:262``) and
``reduce_scatter`` always sums (``:268``), as in the reference.
``broadcast`` and ``scatter`` take ``src`` as the rank in the group:
for a group of ``ranks`` a world rank, mapped to its place in the list,
as the reference maps it (``:247``).

Where the reference cannot express them, ``send`` and ``recv`` move one
tensor between two ranks here (the port's ranks are processes).
``split`` builds the tensor-parallel layers (``tp_layers.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from paddle_tpu_torch.parallel import mesh as _mesh

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "broadcast", "reduce", "scatter", "reduce_scatter",
           "alltoall", "barrier", "send", "recv", "p2p_shift", "wait",
           "split", "get_rank", "get_world_size", "is_initialized",
           "destroy_process_group"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class _Solo:
    """The world of a lone process: one rank."""
    rank, size, ranks = 0, 1, [0]

    def all_to_all(self, x):
        return x.clone()

    def all_gather(self, x):
        return x[None].clone()

    def ring_shift(self, bufs):
        return [b.clone() for b in bufs]

    def send(self, x, dst):
        raise ValueError("send: a lone process has no peer")

    recv = send

    def barrier(self):
        pass

    def split(self, rank_lists):
        return self if any(0 in r for r in rank_lists) else None


_SOLO = _Solo()
_LONE_REGISTRY: dict = {}


class Group:
    """A communicator (reference ``:50``): ``axis`` names the mesh axes it
    spans, ``ranks`` lists its member world ranks."""

    def __init__(self, gid: int, ranks: Optional[List[int]] = None,
                 axis=None, nranks: Optional[int] = None, comm=None):
        self.id = gid
        self.ranks = ranks
        self.axis = axis
        self._nranks = nranks
        self._comm = comm

    @property
    def nranks(self) -> int:
        if self._nranks is not None:
            return self._nranks
        if self.ranks is not None:
            return len(self.ranks)
        if self.axis is not None:
            mesh = _mesh.current_mesh()
            return 1 if mesh is None else mesh.axis_size(self.axis)
        return get_world_size()

    @property
    def rank(self) -> int:
        me = get_rank()
        if self.ranks is not None:
            return self.ranks.index(me) if me in self.ranks else -1
        return me

    def get_group_rank(self, rank):
        if self.ranks is None:
            return rank
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def process_group(self):
        return self

    def __repr__(self):
        return f"Group(id={self.id}, axis={self.axis}, ranks={self.ranks})"


def _registry() -> dict:
    mesh = _mesh.current_mesh()
    reg = _LONE_REGISTRY if mesh is None else mesh.registry
    if 0 not in reg:
        reg[0] = Group(0)
        reg["next"] = 1
    return reg


def _world():
    mesh = _mesh.current_mesh()
    return _SOLO if mesh is None else mesh.group


def _comm(group: Optional[Group]):
    """The primitives of ``group``'s ranks, seen from this rank."""
    if group is not None and group.ranks is not None:
        if group._comm is None:
            raise RuntimeError(f"this rank is not a member of {group}")
        return group._comm
    mesh = _mesh.current_mesh()
    if mesh is None:
        return _SOLO
    if group is None or group.axis is None:
        return mesh.group
    return mesh.axis_group(group.axis)


def is_initialized() -> bool:
    """True, as in the reference (``:110``): a lone process is a world of
    one rank."""
    return True


def get_rank(group: Optional[Group] = None) -> int:
    """This process's world rank, or its place in ``group``'s ranks."""
    r = _world().rank
    if group is not None and group.ranks is not None:
        return group.get_group_rank(r)
    return r


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    return _world().size


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              axis=None) -> Group:
    """A communicator over the mesh ``axis`` (a name or a tuple of names)
    or over the world ``ranks``; every rank calls it, in the same order
    (its process group is created collectively)."""
    reg = _registry()
    gid = reg["next"]
    reg["next"] += 1
    comm = None
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        comm = _world().split([ranks])
    g = Group(gid, ranks=ranks, axis=axis, comm=comm)
    reg[gid] = g
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    return _registry().get(gid)


def destroy_process_group(group: Optional[Group] = None):
    """Forget ``group`` (the world, group 0, stays), as the reference."""
    if group is not None and group.id != 0:
        _registry().pop(group.id, None)


def _write(tensor, out):
    """``out`` into ``tensor`` in place (the reference rebinds its Tensor's
    array); returns ``tensor``."""
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def _reduce(stacked: torch.Tensor, op) -> torch.Tensor:
    """The ranks' values (n, ...) reduced in rank order."""
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        acc = _mesh.ordered_sum(stacked)
        return acc / stacked.shape[0] if op == ReduceOp.AVG else acc
    if op == ReduceOp.MAX:
        return stacked.amax(0)
    if op == ReduceOp.MIN:
        return stacked.amin(0)
    if op == ReduceOp.PROD:
        x = stacked if stacked.is_floating_point() else stacked.float()
        mag = torch.exp(_reduce(torch.log(x.abs()), ReduceOp.SUM))
        n_neg = (x < 0).sum(0)
        any_zero = (x == 0).any(0)
        sign = torch.where(n_neg % 2 == 1, -1.0, 1.0).to(mag.dtype)
        return torch.where(any_zero, torch.zeros_like(mag), sign * mag)
    raise ValueError(f"bad op {op}")


def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op=True, use_calc_stream=None):
    """``tensor`` replaced by its reduction over the group's ranks."""
    comm = _comm(group)
    if comm.size == 1:
        return tensor
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        out = _mesh.sum_over(comm, tensor.detach())
        out = out / comm.size if op == ReduceOp.AVG else out
    else:
        out = _reduce(comm.all_gather(tensor.detach()), op)
    return _write(tensor, out.to(tensor.dtype))


def all_gather(tensor_list, tensor, group: Optional[Group] = None,
               sync_op=True):
    """Appends each rank's ``tensor`` to ``tensor_list`` (when given) and
    returns them stacked, (n, ...).  In a lone process (no mesh, no
    group) the list gets ``tensor`` and ``tensor`` itself comes back, shape
    X, as the reference's eager world of one rank returns it
    (``collective.py:235-240``)."""
    comm = _comm(group)
    if comm is _SOLO:
        if tensor_list is not None:
            tensor_list.append(tensor)
        return tensor.detach()
    out = comm.all_gather(tensor.detach())
    if tensor_list is not None:
        tensor_list.extend(out[i] for i in range(out.shape[0]))
    return out


def _group_src(src: int, group: Optional[Group]) -> int:
    return (src if group is None or group.ranks is None
            else group.get_group_rank(src))


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op=True):
    """``tensor`` replaced by the group rank ``src``'s."""
    comm = _comm(group)
    if comm.size == 1:
        return tensor
    return _write(tensor, comm.all_gather(tensor.detach())[
        _group_src(src, group)])


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM,
           group: Optional[Group] = None, sync_op=True):
    """``all_reduce``: every rank gets the value (reference ``:262``)."""
    return all_reduce(tensor, op=op, group=group)


def reduce_scatter(tensor, tensor_or_list, op=ReduceOp.SUM,
                   group: Optional[Group] = None, sync_op=True):
    """The sum over the ranks of this rank's slice of dim 0 (n slices; a
    list holds them one a rank).  Written into ``tensor`` when given, and
    returned."""
    comm = _comm(group)
    was_list = isinstance(tensor_or_list, (list, tuple))
    arr = (torch.stack([t.detach() for t in tensor_or_list]) if was_list
           else tensor_or_list.detach())
    n = comm.size
    if arr.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(arr.shape)} is "
                         f"not divisible by the group's {n} ranks")
    parts = comm.all_to_all(arr.reshape((n, -1) + tuple(arr.shape[1:])))
    out = _reduce(parts, ReduceOp.SUM)
    if was_list:
        out = out.reshape(out.shape[1:]) if out.shape[0] == 1 else out
    return out if tensor is None else _write(tensor, out)


def scatter(tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op=True):
    """``tensor`` replaced by the group rank ``src``'s ``tensor_list``
    entry for this rank; only ``src`` needs to pass the list.  At one rank
    without a list ``tensor`` stays as it is (reference ``:319-322``)."""
    comm = _comm(group)
    n = comm.size
    if n == 1 and not tensor_list:
        return tensor
    stacked = (torch.stack([t.detach() for t in tensor_list]) if tensor_list
               else torch.zeros((n,) + tuple(tensor.shape),
                                dtype=tensor.dtype, device=tensor.device))
    if n == 1:
        return _write(tensor, stacked[0])
    lists = comm.all_gather(stacked)
    return _write(tensor, lists[_group_src(src, group)][comm.rank])


def alltoall(in_tensor_list, out_tensor_list=None,
             group: Optional[Group] = None, sync_op=True):
    """Entry j of this rank's list goes to rank j; appends what each rank
    sent this one to ``out_tensor_list`` and returns them stacked."""
    arr = (torch.stack([t.detach() for t in in_tensor_list])
           if isinstance(in_tensor_list, (list, tuple))
           else in_tensor_list.detach())
    out = _comm(group).all_to_all(arr)
    if out_tensor_list is not None:
        out_tensor_list.extend(out[i] for i in range(out.shape[0]))
    return out


def p2p_shift(tensor, offset: int = 1, group: Optional[Group] = None,
              wrap: bool = False):
    """Every rank r sends ``tensor`` to r + offset along the group's
    first mesh axis (mod n when ``wrap``) and returns what it receives,
    zeros where no rank sends (reference ``:353``, ``lax.ppermute``)."""
    if group is not None and group.ranks is not None:
        comm = _comm(group)
    else:
        mesh = _mesh.current_mesh()
        axes = (mesh.axes_of(None if group is None else group.axis)
                if mesh is not None else ())
        comm = mesh.axis_group(axes[0]) if axes else _SOLO
    n, r = comm.size, comm.rank
    got = comm.all_gather(tensor.detach())
    src = (r - offset) % n if wrap else r - offset
    return got[src].clone() if 0 <= src < n else torch.zeros_like(tensor)


def send(tensor, dst: int = 0, group: Optional[Group] = None, sync_op=True):
    """``tensor`` to the rank ``dst`` (a world rank), which calls
    ``recv``."""
    _comm(group).send(tensor.detach(), _group_src(dst, group))


def recv(tensor, src: int = 0, group: Optional[Group] = None, sync_op=True):
    """``tensor`` filled with what rank ``src`` sends."""
    with torch.no_grad():
        return _comm(group).recv(tensor, _group_src(src, group))


def barrier(group: Optional[Group] = None):
    _comm(group).barrier()


def wait(tensor, group=None, use_calc_stream=True):
    """Blocks the host until ``tensor``'s pending work is done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def split(x, size, operation: str, axis: int = 0, num_partitions: int = 1,
          gather_out: bool = True, weight_attr=None, bias_attr=None,
          name=None):
    """Megatron-style parallel linear / embedding (reference ``:443``):
    ``"linear"`` with ``axis`` 1 or -1 a ``ColumnParallelLinear`` (its
    output gathered when ``gather_out``), any other axis a
    ``RowParallelLinear``; ``"embedding"`` a ``VocabParallelEmbedding``;
    any other operation raises ``ValueError``.  ``size`` is (in, out) or
    (vocabulary, width).  Returns the layer applied to ``x`` when x is a
    tensor, else the layer."""
    from paddle_tpu_torch.distributed.tp_layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    if operation == "linear":
        in_f, out_f = size
        if axis in (1, -1):
            layer = ColumnParallelLinear(in_f, out_f,
                                         gather_output=gather_out,
                                         weight_attr=weight_attr,
                                         bias_attr=bias_attr)
        else:
            layer = RowParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                      bias_attr=bias_attr)
    elif operation == "embedding":
        n, d = size
        layer = VocabParallelEmbedding(n, d, weight_attr=weight_attr)
    else:
        raise ValueError(f"unsupported split operation {operation!r}")
    return layer(x) if isinstance(x, torch.Tensor) else layer
