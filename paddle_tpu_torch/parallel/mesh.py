"""The device mesh over torch.distributed (port of paddle_tpu/parallel/
mesh.py :55-282).

The reference names a mesh of devices and lets ``shard_map`` place one
replica on each; here each replica is a process (a rank), and a
:class:`Mesh` names the axes the ranks are laid out on (``{"dp": 2,
"sharding": 2}``), row-major in the reference's axis order (``pp``
outermost, then ``dp``, ``sharding``, ``mp``, ``sp``, ``ep``), with the
group of all its ranks (``mesh.group``) and, on demand, the group of the
ranks that share this rank's coordinates on every other axis
(:meth:`Mesh.axis_group`): the reference's collectives over named axes.

A group offers the primitives the steps and the collective API build on:

- ``all_to_all(x)``: x (n, ...) -> out (n, ...) with ``out[j]`` rank j's
  ``x[rank]``;
- ``all_gather(x)``: x (...) -> (n, ...), rank j's x at j;
- ``ring_shift(bufs)``: send each tensor to rank + 1 and receive the same
  shapes from rank - 1, one neighbour hop;
- ``send(x, dst)`` / ``recv(x, src)``: one tensor between two ranks
  (``isend`` returns without waiting for the receiver: the pipeline's
  stages send to each other in one tick);
- ``split(rank_lists)``: the subgroup, among the given partition of the
  group's world ranks, that holds this rank.

The reductions build on them in one order: :func:`ordered_sum` adds the
ranks' values in rank order, and :func:`sum_over` / :func:`mean_over`
reduce a tensor over a group as a reduce-scatter (an all-to-all, then
each rank's ordered sum of its chunk) and an all-gather of the chunks.
That is a ring all-reduce's traffic, 2 (n - 1) / n of the tensor a
rank, and a few copies of it whatever n, where an all-gather of the
whole would hold n; and the same bits on every rank, backend and layout
(NCCL's and gloo's own all-reduce each choose their order).

:class:`DistGroup` runs them over a ``torch.distributed`` process group
(the default group unless one is given): NCCL for a model on the card,
gloo for ``device="cpu"`` (:func:`init_process_group` picks the backend).
:class:`LoopbackWorld` runs n ranks as threads of one process, each rank
on its own replica, with the same primitives by exchange in memory: the
way to run dp >= 2 on a machine with one card, where NCCL refuses two
ranks on one device.  Each rank thread has its own current mesh
(:func:`get_mesh` inside ``LoopbackWorld.run`` answers the rank's).

A mesh may name ``mp``, ``sp`` and ``pp`` too: ``ShardedTrainStep``,
the tensor-parallel layers and GPT run them (``parallel/tp.py``,
``parallel/ring_attention.py``, ``parallel/pipeline.py``); ``ep`` (no
user in the reference) raises.  ``DistAttr`` and ``shard_spec`` keep the
reference's annotations (a tuple of axis names a dim is split over).
The port's program is manual on every rank, so :func:`constrain` only
checks its spec, and :func:`shard_map_compat` runs a function on each
rank's slices of its inputs and all-gathers its outputs.
"""
from __future__ import annotations

import contextlib
import math
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from paddle_tpu_torch.device import resolve_device

__all__ = ["Mesh", "DistGroup", "LoopbackWorld", "make_mesh", "set_mesh",
           "ordered_sum", "sum_over", "mean_over",
           "get_mesh", "init_process_group", "auto_mesh", "mesh_axis_size",
           "shard_spec", "DistAttr", "HybridTopology", "AXIS_ORDER",
           "constrain", "manual_region", "shard_map_compat"]

# canonical axis order (reference :51): pipeline outermost, model innermost
AXIS_ORDER = ("pp", "dp", "sharding", "mp", "sp", "ep")


def ordered_sum(stacked: torch.Tensor) -> torch.Tensor:
    """``stacked[0] + stacked[1] + ...`` added in that order, in stacked's
    dtype."""
    acc = stacked[0].clone()
    for j in range(1, stacked.shape[0]):
        acc += stacked[j]
    return acc


def sum_over(group, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, added in rank order in t's
    dtype: the all-to-all of t's n chunks (t flattened, padded to a
    multiple of n), the ordered sum of this rank's chunk, the all-gather
    of the chunks."""
    n = group.size
    if n == 1:
        return t.clone()
    flat = t.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % n)])
    part = ordered_sum(group.all_to_all(flat.reshape(n, -1)))
    return group.all_gather(part).reshape(-1)[:t.numel()].reshape(t.shape)


def mean_over(group, t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the group's ranks (the reference's
    ``pmean``), summed as :func:`sum_over` sums, in t's dtype promoted to
    at least f32: the caller casts back."""
    acc = torch.promote_types(t.dtype, torch.float32)
    return sum_over(group, t.to(acc)) / group.size


class DistGroup:
    """The collective primitives over a torch.distributed group."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialised: call "
                "parallel.init_process_group (or torch.distributed."
                "init_process_group) first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.ranks = (list(range(self.size)) if group is None
                      else dist.get_process_group_ranks(group))

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
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        recv = [torch.empty_like(b) for b in bufs]
        ops = ([dist.P2POp(dist.isend, b.contiguous(), nxt, self.group)
                for b in bufs]
               + [dist.P2POp(dist.irecv, r, prv, self.group) for r in recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def send(self, x: torch.Tensor, dst: int):
        dist.send(x.contiguous(), self.ranks[dst], group=self.group)

    def isend(self, x: torch.Tensor, dst: int):
        """``send`` without waiting: the work to ``wait()`` on (x must stay
        alive and unchanged until then)."""
        return dist.isend(x.contiguous(), self.ranks[dst], group=self.group)

    def recv(self, x: torch.Tensor, src: int) -> torch.Tensor:
        dist.recv(x, self.ranks[src], group=self.group)
        return x

    def barrier(self):
        dist.barrier(group=self.group)

    def split(self, rank_lists: Sequence[Sequence[int]]) -> "DistGroup":
        """Every rank of the group calls this with the same lists:
        ``dist.new_group`` is collective over the world.  None where this
        rank is in no list."""
        mine = None
        for ranks in rank_lists:
            g = dist.new_group(list(ranks))
            if self.ranks[self.rank] in ranks:
                mine = g
        return None if mine is None else DistGroup(mine)


class _Exchange:
    """The rendezvous of a set of loopback ranks: slots and a barrier."""

    def __init__(self, n: int, timeout: float):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)

    def __call__(self, idx: int, obj, read=list):
        """Post ``obj``, then ``read`` the ranks' posts (copy what it
        keeps: a rank may write its tensor in place once every rank has
        read)."""
        self.slots[idx] = obj
        self.barrier.wait()
        got = read(self.slots)
        self.barrier.wait()              # every rank has read the slots
        return got


class LoopbackWorld:
    """``n`` ranks in one process: :meth:`run` calls ``fn(rank, mesh)`` on
    n threads and returns their results in rank order.  The collectives
    meet at a barrier and exchange tensors by reference, on the one device
    all ranks share (work on one CUDA stream stays in its order).  A rank
    that raises breaks the barriers, so the others raise too, and the
    first error is re-raised."""

    def __init__(self, n: int, timeout: float = 600.0):
        self.n = int(n)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._exchanges: Dict[Tuple[int, ...], _Exchange] = {}
        self._mailboxes: Dict[Tuple[int, int], queue.Queue] = {}
        self._aborted = False

    def _exchange(self, ranks: Tuple[int, ...]) -> _Exchange:
        with self._lock:
            ex = self._exchanges.get(ranks)
            if ex is None:
                ex = self._exchanges[ranks] = _Exchange(len(ranks),
                                                        self.timeout)
                if self._aborted:
                    ex.barrier.abort()
            return ex

    def _mailbox(self, src: int, dst: int) -> queue.Queue:
        with self._lock:
            return self._mailboxes.setdefault((src, dst), queue.Queue())

    def _abort(self):
        with self._lock:
            self._aborted = True
            for ex in self._exchanges.values():
                ex.barrier.abort()

    def run(self, fn: Callable, axes: Optional[Dict[str, int]] = None
            ) -> list:
        """``axes`` lays the n ranks out on a mesh ({"dp": n} when None)."""
        results: list = [None] * self.n
        errors: list = [None] * self.n
        world = tuple(range(self.n))

        def body(rank):
            _LOCAL.world = True
            _LOCAL.world_rank = rank
            try:
                mesh = Mesh(axes or {"dp": self.n},
                            _LoopbackGroup(self, world, rank))
                _LOCAL.mesh = mesh
                results[rank] = fn(rank, mesh)
            except BaseException as e:    # noqa: BLE001 - re-raised below
                errors[rank] = e
                self._abort()

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
    """The group of world ranks ``ranks`` of a :class:`LoopbackWorld`, seen
    from world rank ``me``."""

    def __init__(self, world: LoopbackWorld, ranks: Tuple[int, ...],
                 me: int):
        self.world = world
        self.ranks = list(ranks)
        self.rank = self.ranks.index(me)
        self.size = len(ranks)
        self._ex = world._exchange(tuple(ranks))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return self._ex(self.rank, x, lambda got: torch.stack(
            [got[j][self.rank] for j in range(self.size)]))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._ex(self.rank, x, torch.stack)

    def ring_shift(self, bufs) -> List[torch.Tensor]:
        prv = (self.rank - 1) % self.size
        return self._ex(self.rank, list(bufs),
                        lambda got: [b.clone() for b in got[prv]])

    def send(self, x: torch.Tensor, dst: int):
        self.world._mailbox(self.ranks[self.rank], self.ranks[dst]).put(
            x.detach().clone())

    def isend(self, x: torch.Tensor, dst: int):
        """``send``, which never waits here: nothing to wait on."""
        self.send(x, dst)

    def recv(self, x: torch.Tensor, src: int) -> torch.Tensor:
        got = self.world._mailbox(self.ranks[src], self.ranks[self.rank]
                                  ).get(timeout=self.world.timeout)
        x.copy_(got)
        return x

    def barrier(self):
        self._ex(self.rank, None)

    def split(self, rank_lists: Sequence[Sequence[int]]) -> "_LoopbackGroup":
        me = self.ranks[self.rank]
        mine = next((tuple(r) for r in rank_lists if me in r), None)
        return None if mine is None else _LoopbackGroup(self.world, mine, me)


def _ordered_axes(names) -> List[str]:
    return [a for a in AXIS_ORDER if a in names] + [
        a for a in names if a not in AXIS_ORDER]


class Mesh:
    """Named axes over ``group``'s ranks: ``shape`` ({axis: size}, in the
    reference's axis order; the sizes multiply to the group's size) and
    ``group``, the collectives of this rank (``rank``) among them all."""

    def __init__(self, shape: Dict[str, int], group):
        names = _ordered_axes(shape)
        self.shape = {a: int(shape[a]) for a in names}
        self.axis_names = tuple(names)
        self.group = group
        if math.prod(self.shape.values()) != group.size:
            raise ValueError(f"mesh axes {self.shape} do not lay out the "
                             f"group's {group.size} ranks")
        self._axis_groups: Dict[Tuple[str, ...], object] = {}
        self.registry: dict = {}          # collective.new_group's groups

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def size(self) -> int:
        return self.group.size

    def axes_of(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names, or None for all) as the
        mesh's own axes in mesh order; absent names are dropped."""
        if axes is None:
            return self.axis_names
        want = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in want)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes_of(axes))

    def axis_group(self, axes):
        """The group of the ranks that share this rank's coordinates on
        every axis but ``axes``, in row-major order of ``axes`` (the
        reference's collectives over those mesh axes).  Built once an axis
        set, on every rank in the same order (``dist.new_group`` is
        collective)."""
        key = self.axes_of(axes)
        if key not in self._axis_groups:
            topo = HybridTopology(self)
            if self.axis_size(key) == self.size:
                g = self.group
            else:
                lists, seen = [], set()
                for r in range(self.size):
                    if r in seen:
                        continue
                    members = topo.group_ranks(r, key)
                    seen.update(members)
                    lists.append([self.group.ranks[m] for m in members])
                g = self.group.split(lists)
            self._axis_groups[key] = g
        return self._axis_groups[key]

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over them in mesh
        order), its place in :meth:`axis_group` of the same axes."""
        topo = HybridTopology(self)
        idx = 0
        for a in self.axes_of(axes):
            idx = idx * self.shape[a] + topo.axis_rank(self.rank, a)
        return idx

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


def require_no_model_parallel(mesh: Mesh, who: str):
    """Raise NotImplementedError when ``mesh`` has an axis of size > 1
    the port does not run: ``ep`` (expert parallelism, which no model of
    the reference runs).  ``mp``, ``sp`` and ``pp`` run."""
    extra = {a: s for a, s in mesh.shape.items()
             if a not in ("dp", "sharding", "mp", "sp", "pp") and s > 1}
    if extra:
        raise NotImplementedError(
            f"{who} over the axes {extra}: expert parallelism (ep) has no "
            "user in the reference")


def init_process_group(device=None, *, rank: int, world_size: int,
                       init_method: str):
    """``torch.distributed.init_process_group`` with the backend of the
    model's device (the default device when None): NCCL for ``"cuda"``
    (after selecting the card ``rank % device_count``), gloo for
    ``"cpu"``.  ``init_method`` is an
    address such as ``tcp://localhost:<port>``.  The device is checked as
    every entry point checks it (``device.resolve_device``): CUDA asked
    for where there is none raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


_LOCAL = threading.local()


def in_loopback() -> bool:
    """Whether the calling thread is a rank of a :class:`LoopbackWorld`."""
    return getattr(_LOCAL, "world", False)


def lead_thread() -> bool:
    """Whether the calling thread speaks for its process in the host
    planes (spans, statistics, compile sites): any thread but the ranks of
    a :class:`LoopbackWorld` other than rank 0.  The reference's single
    controller records a step once; the port's loopback ranks run it on n
    threads of one process, and record it once."""
    return not in_loopback() or _LOCAL.world_rank == 0


def world_group():
    """This rank's group of all ranks: the loopback rank's world, else the
    default torch.distributed group (raises when it is not initialised)."""
    if in_loopback():
        return _LOCAL.mesh.group
    return DistGroup(None)


def make_mesh(axes: Dict[str, int], group=None) -> Mesh:
    """A mesh of the named axes over ``group`` (the calling rank's world
    when None); a size of -1 takes what the others leave.  The sizes must
    lay out every rank of the group: the port's ranks each hold a replica,
    so a sub-mesh over fewer ranks (the reference's ``devices[:need]``)
    raises."""
    g = world_group() if group is None else (
        group if hasattr(group, "all_gather") else DistGroup(group))
    names = _ordered_axes(axes)
    sizes = [int(axes[a]) for a in names]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = g.size // known
    shape = dict(zip(names, sizes)) or {"dp": g.size}
    if math.prod(shape.values()) != g.size:
        raise ValueError(f"mesh axes {shape} do not lay out the "
                         f"{g.size} ranks of the world")
    return Mesh(shape, g)


def auto_mesh(dp: int = -1, mp: int = 1, pp: int = 1, sharding: int = 1,
              sp: int = 1, ep: int = 1, group=None) -> Mesh:
    """Fleet-style mesh from hybrid degrees (reference :81)."""
    axes = {}
    for name, size in (("pp", pp), ("dp", dp), ("sharding", sharding),
                       ("mp", mp), ("sp", sp), ("ep", ep)):
        if size != 1:
            axes[name] = size
    return make_mesh(axes or {"dp": -1}, group)


_global_mesh: Optional[Mesh] = None


def set_mesh(mesh: Mesh) -> Mesh:
    """Make ``mesh`` the active one: the rank's own inside a
    :class:`LoopbackWorld`, the process's otherwise."""
    global _global_mesh
    if in_loopback():
        _LOCAL.mesh = mesh
    else:
        _global_mesh = mesh
    return mesh


def get_mesh() -> Mesh:
    """The active mesh; by default a dp mesh over the whole world."""
    global _global_mesh
    if in_loopback():
        return _LOCAL.mesh
    if _global_mesh is None:
        _global_mesh = make_mesh({"dp": -1})
    return _global_mesh


def current_mesh() -> Optional[Mesh]:
    """The active mesh, or None where none is set and torch.distributed is
    not initialised (a lone process)."""
    if in_loopback():
        return _LOCAL.mesh
    if _global_mesh is None and not dist.is_initialized():
        return None
    return get_mesh()


def mesh_axis_size(axis: str, mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or get_mesh()
    return mesh.shape.get(axis, 1)


def _clean_axes(axes, mesh: Mesh) -> tuple:
    """Drop axes absent from ``mesh`` (they become replicated) and the
    trailing Nones (reference :109)."""
    cleaned = []
    for a in axes:
        if a is None:
            cleaned.append(None)
        elif isinstance(a, (tuple, list)):
            keep = tuple(x for x in a if x in mesh.shape)
            cleaned.append(keep if keep else None)
        else:
            cleaned.append(a if a in mesh.shape else None)
    while cleaned and cleaned[-1] is None:
        cleaned.pop()
    return tuple(cleaned)


def shard_spec(*axes) -> tuple:
    """Mesh-tolerant partition spec over the active mesh (a tuple, the
    reference's ``PartitionSpec`` entries)."""
    return _clean_axes(axes, get_mesh())


class DistAttr:
    """Sharding annotation carried by a parameter (reference :186): the
    mesh axes each of its dims is split over.  ``ShardedTrainStep`` reads
    it on a mesh with ``mp`` > 1: a parameter split over ``mp`` must be
    held in shards by an mp-aware layer or model (its ``mp_split``, set by
    ``parallel.tp.shard_parameter``), else the step raises."""

    __slots__ = ("spec",)

    def __init__(self, spec: Sequence):
        self.spec = tuple(spec)

    def sharding(self, mesh: Optional[Mesh] = None) -> tuple:
        return _clean_axes(self.spec, mesh or get_mesh())

    def __repr__(self):
        return f"DistAttr({self.spec})"


_MANUAL = threading.local()


@contextlib.contextmanager
def manual_region():
    """Mark a region run on each rank's slices (reference :139):
    :func:`constrain` checks nothing inside it."""
    prev = getattr(_MANUAL, "depth", 0)
    _MANUAL.depth = prev + 1
    try:
        yield
    finally:
        _MANUAL.depth = prev


def in_manual_region() -> bool:
    return getattr(_MANUAL, "depth", 0) > 0


class _OneRank:
    shape = {"dp": 1}


def constrain(arr, *axes, strip=()):
    """The reference's sharding constraint (``:161``).  The port's program
    is already manual on each rank, so the tensor comes back as it is; the
    spec is still checked against it as the reference checks it: axes
    absent from the active mesh (or in ``strip``) are dropped, and a spec
    longer than the tensor's rank raises."""
    if in_manual_region():
        return arr
    axes = tuple(None if a in strip else a for a in axes)
    spec = _clean_axes(axes, current_mesh() or _OneRank())
    if len(spec) > arr.dim():
        raise ValueError(f"sharding spec {spec} has rank {len(spec)} > "
                         f"array rank {arr.dim()}")
    return arr


def _spec_dims(spec, mesh: Mesh):
    """[(dim, axes)] of the dims a spec splits over the mesh's axes."""
    out = []
    for d, a in enumerate(_clean_axes(tuple(spec or ()), mesh)):
        if a is not None and mesh.axis_size(a) > 1:
            out.append((d, mesh.axes_of(a)))
    return out


def _local_slice(t, spec, mesh: Mesh):
    for d, axes in _spec_dims(spec, mesh):
        n = mesh.axis_size(axes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        w = t.shape[d] // n
        t = t.narrow(d, mesh.axis_index(axes) * w, w)
    return t


def _assemble(t, spec, mesh: Mesh):
    for d, axes in reversed(_spec_dims(spec, mesh)):
        t = torch.cat(list(mesh.axis_group(axes).all_gather(
            t.contiguous()).unbind(0)), d)
    return t


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs):
    """``f`` over the ranks' slices (reference ``:31``): the returned
    function takes the global inputs, gives ``f`` this rank's slice of
    each (``in_specs``, one spec a input: a tuple of the axes each dim is
    split over), and assembles each output by all-gathering it over the
    axes its spec names (``out_specs``: one spec, or a sequence of them
    where ``f`` returns a tuple).  Every rank of the mesh calls it; a dim
    no spec splits comes back as this rank's value."""
    def mapped(*args):
        local = [_local_slice(a, s, mesh) for a, s in zip(args, in_specs)]
        with manual_region():
            out = f(*local)
        if isinstance(out, (tuple, list)):
            return type(out)(_assemble(o, s, mesh)
                             for o, s in zip(out, out_specs))
        return _assemble(out, out_specs, mesh)
    return mapped


class HybridTopology:
    """Rank-coordinate bookkeeping over a named mesh (reference :210):
    world rank -> coordinates (row-major over the mesh's axes), the ranks
    of a rank's group along an axis, the degrees."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self._mesh = mesh or get_mesh()
        self._names = list(self._mesh.axis_names)
        self._sizes = [self._mesh.shape[n] for n in self._names]
        self._n = math.prod(self._sizes)

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    def world_size(self) -> int:
        return self._n

    def coordinate(self, rank: int) -> Tuple[int, ...]:
        coord = []
        rem = rank
        for size in reversed(self._sizes):
            coord.append(rem % size)
            rem //= size
        return tuple(reversed(coord))

    def rank_of(self, coord: Sequence[int]) -> int:
        rank = 0
        for c, size in zip(coord, self._sizes):
            rank = rank * size + c
        return rank

    def _axis_idx(self, axis: str) -> int:
        if axis not in self._names:
            raise ValueError(f"axis {axis!r} not in mesh {self._names}")
        return self._names.index(axis)

    def get_degree(self, axis: str) -> int:
        return self._sizes[self._axis_idx(axis)] if axis in self._names else 1

    def axis_rank(self, rank: int, axis: str) -> int:
        """This rank's index along ``axis`` (e.g. its pipeline stage)."""
        if axis not in self._names:
            return 0
        return self.coordinate(rank)[self._axis_idx(axis)]

    def group_ranks(self, rank: int, axes) -> List[int]:
        """All world ranks in ``rank``'s communicator along ``axes`` (one
        name or several), in row-major order of those axes (reference
        ``topology.py`` get_comm_group)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [self._axis_idx(a) for a in names]
        idx.sort()
        coord = list(self.coordinate(rank))
        out = []
        for flat in range(math.prod(self._sizes[i] for i in idx)):
            rem = flat
            for i in reversed(idx):
                coord[i] = rem % self._sizes[i]
                rem //= self._sizes[i]
            out.append(self.rank_of(coord))
        return out

    def get_data_parallel_world_size(self):
        return self.get_degree("dp")

    def get_model_parallel_world_size(self):
        return self.get_degree("mp")

    def get_pipe_parallel_world_size(self):
        return self.get_degree("pp")

    def get_sharding_parallel_world_size(self):
        return self.get_degree("sharding")
