"""The mesh-sharded device-resident embedding (port of paddle_tpu/
distributed/ps/device_table.py): the heter-PS middle tier, for tables that
fit the cards' memory together but not one card.

The table is range-sharded over a mesh axis (``dp`` by default): on a mesh
whose axis has K ranks, rank r holds rows [r V'/K, (r + 1) V'/K) of the
table padded to V' (a multiple of K), and its slice of dim 0 of the batch
(the DLRM / heter-PS layout, table shards and workers on the same ranks).
A lookup runs the reference's cycle by hand on each rank (its
``shard_map`` body):

1. **local dedup**: :func:`_sort_dedup` packs the rank's distinct ids into
   the low slots of a tensor of the batch's size;
2. **id exchange**: the all-gather of the (``capacity``-bounded) unique ids
   over the axis;
3. **local gather**: each rank reads the rows it owns and zeros for the
   rest;
4. **rows ride back**: a reduce-scatter sums the owners' rows (one
   non-zero each) and hands each rank the rows of its own unique ids;
5. the per-slot rows are re-gathered from the unique ones; ids past
   ``capacity`` read zero rows and pass no gradient.

Every sum over ranks is :func:`parallel.mesh.ordered_sum` in rank order,
so each rank reads the bits of a plain gather.  With no mesh, or an axis
of one rank, the lookup is the reference's plain ``w[ids]``: a negative id
counts from the end and one past the table reads the last row (clamped),
passing no gradient.  On the mesh path an id outside [0, V') owns no row
and reads zeros, as in the reference.

:class:`DeviceEmbeddingTrainStep` runs the whole cycle of a training step
on each rank: the exchange, the dense net's loss and gradients (its own
and the pulled rows'), the dense gradients averaged over the axis, the
reverse exchange of the row gradients to their owners, and adagrad (or
SGD) on the touched rows only, in the reference's order.  No Pallas
kernel lies on this tier; it is PyTorch tensor ops and the mesh's
collectives.  :class:`HotRowSketch` is the host tables' hot-row telemetry.
"""
from __future__ import annotations

import heapq
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.parameter import Parameter
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.parallel import tp
from paddle_tpu_torch.parallel.mesh import (DistAttr, _local_slice,
                                            current_mesh, mean_over,
                                            ordered_sum)

__all__ = ["MeshShardedEmbedding", "mesh_sharded_lookup",
           "DeviceEmbeddingTrainStep", "HotRowSketch"]


class HotRowSketch:
    """Bounded top-k frequent-row sketch (space-saving, reference
    ``:74-187``): at most ``capacity`` counters (default ``8 k``); an
    unseen id replaces the current minimum counter and inherits its count,
    in one heap sweep a batch.  Thread-safe."""

    def __init__(self, k: int = 32, capacity: Optional[int] = None):
        self.k = int(k)
        self.capacity = int(capacity) if capacity is not None \
            else max(self.k * 8, self.k)
        self._counts: dict = {}
        self.total = 0                 # ids observed (not distinct)
        self._lock = threading.Lock()

    def update(self, ids, counts=None):
        """Fold one batch of row ids in; ``counts`` (aligned) weights
        them."""
        flat = np.asarray(ids).reshape(-1)
        if flat.size == 0:
            return
        if counts is None:
            uniq, cnt = np.unique(flat, return_counts=True)
        else:
            w = np.asarray(counts).reshape(-1)
            uniq, inv = np.unique(flat, return_inverse=True)
            cnt = np.zeros(uniq.shape[0], w.dtype)
            np.add.at(cnt, inv, w)
        with self._lock:
            c = self._counts
            cold = []
            for i, n in zip(uniq.tolist(), cnt.tolist()):
                n = int(n)
                self.total += n
                if i in c:
                    c[i] += n
                elif len(c) < self.capacity:
                    c[i] = n
                else:
                    cold.append((n, i))
            if cold:
                # each cold id evicts the current minimum, heaviest first
                heap = [(cnt, vid) for vid, cnt in c.items()]
                heapq.heapify(heap)
                cold.sort(reverse=True)
                for n, i in cold:
                    floor, vid = heapq.heappop(heap)
                    while vid not in c or c[vid] != floor:
                        floor, vid = heapq.heappop(heap)     # stale entry
                    del c[vid]
                    c[i] = floor + n
                    heapq.heappush(heap, (floor + n, i))

    def merge(self, top_rows):
        """Fold another sketch's ``top()`` rows in: [(id, count), ...]."""
        if not top_rows:
            return
        ids = np.asarray([r[0] for r in top_rows], np.int64)
        cnt = np.asarray([r[1] for r in top_rows], np.int64)
        self.update(ids, counts=cnt)

    def top(self, n: Optional[int] = None):
        """The ``n`` (default ``k``) hottest rows, [(id, count), ...],
        hottest first, ties by id."""
        n = self.k if n is None else int(n)
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return [(int(i), int(c)) for i, c in items[:n]]

    def snapshot(self) -> dict:
        with self._lock:
            tracked = len(self._counts)
        return {"k": self.k, "capacity": self.capacity,
                "total": self.total, "tracked": tracked, "top": self.top()}

    def reset(self):
        with self._lock:
            self._counts.clear()
            self.total = 0


def _sort_dedup(flat: torch.Tensor):
    """Static-shape unique (reference ``:190-201``): (uniq, inv) with
    ``uniq[inv] == flat``; the distinct values fill the low slots in
    ascending order, the slots past them stay 0 and no ``inv`` points
    there."""
    n = flat.shape[0]
    s, order = torch.sort(flat, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=flat.device)
    first[1:] = s[1:] != s[:-1]
    slot = torch.cumsum(first, 0) - 1
    uniq = torch.zeros_like(flat).scatter_(0, slot, s)
    inv = torch.zeros(n, dtype=torch.long, device=flat.device).scatter_(
        0, order, slot)
    return uniq, inv


def clamped_rows(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The reference's ``w[ids]``: a negative id counts from the end, one
    still outside [0, V) reads the nearest edge row and passes it no
    gradient (XLA's clamped gather)."""
    V = w.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + V, ids)
    valid = ((ids >= 0) & (ids < V))[..., None]
    out = w[ids.clamp(0, V - 1)]
    return torch.where(valid, out, out.detach())


def gather_rows(rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``rows[inv]`` for an ``inv`` known to lie in range, as an embedding
    lookup: its backward sums a repeated index's gradients in parallel
    segments, where indexing's backward walks each index's repeats one
    after another (a hot id of a skewed batch repeats 10^5 times)."""
    return torch.nn.functional.embedding(inv, rows)


class _ReduceScatter(torch.autograd.Function):
    """(K c, D) -> (c, D): the sum over the group, in rank order, of every
    rank's chunk ``rank``; the all-gather of the gradient backward (the
    reference's ``psum_scatter`` and its transpose).  On loopback ranks on
    the card the output is handed over on the host (``parallel/tp.py``'s
    hop), so the backward's collective runs on the rank's own thread."""

    @staticmethod
    def forward(ctx, x, group, hop):
        ctx.group, ctx.device, ctx.hop = group, x.device, hop
        chunks = x.detach().reshape(group.size, -1, x.shape[-1])
        return tp._out(ordered_sum(group.all_to_all(chunks.contiguous())),
                       hop)

    @staticmethod
    def backward(ctx, g):
        g = tp._back(g, ctx.device, ctx.hop).contiguous()
        return ctx.group.all_gather(g).reshape(-1, g.shape[-1]), None, None


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    hop = tp.needs_hop(x)
    y = _ReduceScatter.apply(x, group, hop)
    return y.to(x.device) if hop else y


class _Exchange:
    """One rank's pull of the cycle (steps 1-4): its unique ids, the
    inverse map, the gathered requests of all ranks, which of them this
    rank owns and where, and the capacity."""

    def __init__(self, ids_l: torch.Tensor, rows_per: int, group,
                 capacity: Optional[int]):
        flat = ids_l.reshape(-1).long()
        self.n = n = flat.shape[0]
        self.uniq, self.inv = _sort_dedup(flat)
        self.cap = cap = n if capacity is None else int(min(capacity, n))
        k = 1 if group is None else group.size
        rank = 0 if group is None else group.rank
        u = self.uniq[:cap].contiguous()
        self.flat_u = u if k == 1 else group.all_gather(u).reshape(-1)
        loc = self.flat_u - rank * rows_per
        self.owned = (loc >= 0) & (loc < rows_per)
        self.clipped = loc.clamp(0, rows_per - 1)
        self.group, self.k = group, k

    def rows(self, w_l: torch.Tensor) -> torch.Tensor:
        """Step 3: the owned rows of every request, zeros elsewhere."""
        got = w_l[self.clipped]
        return torch.where(self.owned[:, None], got, torch.zeros_like(got))

    def back(self, rows_all: torch.Tensor) -> torch.Tensor:
        """Step 4: this rank's (cap, D) rows, summed over the owners."""
        return rows_all if self.k == 1 else _reduce_scatter(rows_all,
                                                            self.group)

    def per_slot(self, mine: torch.Tensor, shape) -> torch.Tensor:
        """Step 5: the per-slot rows; overflow slots read zeros."""
        got = gather_rows(mine, self.inv.clamp(max=self.cap - 1))
        if self.cap < self.n:
            over = (self.inv >= self.cap)[:, None]
            got = torch.where(over, torch.zeros_like(got), got)
        return got.reshape(tuple(shape) + (mine.shape[-1],))


def _axis(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def mesh_sharded_lookup(w, ids, axis: str = "dp", mesh=None,
                        capacity: Optional[int] = None) -> torch.Tensor:
    """Differentiable sharded-table lookup.  ``w`` is this rank's row
    block (the whole table where ``axis`` has one rank), ``ids`` (B, ...)
    the global batch, B divisible by the axis size.  Returns the (B, ...,
    D) rows of the whole batch on every rank: the rank's slice runs the
    exchange and the slices are all-gathered (the reference's
    ``out_specs``).  With no mesh, or ``axis`` of size 1, the plain
    clamped gather."""
    mesh = mesh if mesh is not None else current_mesh()
    ids = torch.as_tensor(ids, device=w.device)
    if _axis(mesh, axis) <= 1:
        return clamped_rows(w, ids)
    group = mesh.axis_group(axis)
    ids_l = _local_slice(ids, (axis,), mesh)
    ex = _Exchange(ids_l, w.shape[0], group, capacity)
    out = ex.per_slot(ex.back(ex.rows(w)), ids_l.shape)
    return tp.gather(out, group, 0)


class MeshShardedEmbedding(Layer):
    """An embedding whose table is range-sharded over ``mesh_axis`` with
    the per-step dedup and exchange (reference ``:204-323``).  The table
    is padded to a multiple of the axis size K and drawn whole from
    ``default_rng(seed)`` as the reference draws it, ``(V', E)`` float32
    scaled in place, so it depends on K; a rank keeps its row block.  Ids
    must stay below ``num_embeddings``.  The mesh is ``mesh``, else the
    active one (one rank with none)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 mesh_axis: str = "dp", capacity: Optional[int] = None,
                 initializer_range: float = 0.05, seed: int = 0,
                 name=None, device=None, mesh=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.mesh_axis = mesh_axis
        self.capacity = capacity
        self.mesh = mesh if mesh is not None else current_mesh()
        k = _axis(self.mesh, mesh_axis)
        self._vocab_padded = int(math.ceil(num_embeddings / k) * k)
        dev = resolve_device(device)
        t = init_table(self._vocab_padded, embedding_dim, initializer_range,
                       seed)
        rows = self._vocab_padded // k
        lo = (self.mesh.axis_index(mesh_axis) if k > 1 else 0) * rows
        self.weight = Parameter(torch.from_numpy(t[lo:lo + rows]).to(dev),
                                name=name or "mesh_sharded_embedding")
        self.weight.dist_attr = DistAttr((mesh_axis, None))

    def forward(self, x):
        return mesh_sharded_lookup(self.weight, x, axis=self.mesh_axis,
                                   mesh=self.mesh, capacity=self.capacity)


DRAW_BLOCK = 1 << 24            # init_table: values a block of the draw


def init_table(rows: int, dim: int, initializer_range: float,
               seed: int) -> np.ndarray:
    """The reference tables' draw: float32 ``rng.random`` scaled in place
    to [-r, r) (no float64 temporary; reference ``:286-292`` and
    ``ps/__init__.py:104-110``).

    The draw runs in blocks of DRAW_BLOCK values on the host's cores,
    bitwise the one stream: PCG64 gives two float32 from each 64-bit
    output, so a block that starts at an even value starts on a whole
    output, and its generator is the seed's advanced by half its start
    (a 100M x 65 table, 26 GB, takes ~41 s on one core)."""
    r2, r = np.float32(2.0 * initializer_range), np.float32(initializer_range)
    t = np.empty((rows, dim), np.float32)
    flat = t.reshape(-1)
    block = DRAW_BLOCK + DRAW_BLOCK % 2

    def fill(start):
        part = flat[start:start + block]
        bits = np.random.PCG64(seed)
        bits.advance(start // 2)
        np.random.Generator(bits).random(out=part, dtype=np.float32)
        part *= r2
        part -= r

    starts = range(0, flat.size, block)
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count() or 1
    with ThreadPoolExecutor(max(1, min(cores, len(starts)))) as pool:
        list(pool.map(fill, starts))
    return t


class DeviceEmbeddingTrainStep:
    """The heter-PS worker cycle with the table on the cards (reference
    ``:326-498``): the pull (dedup and exchange), the dense net's forward,
    backward and update, and a touched-rows-only table optimizer, on each
    rank of ``embedding``'s axis.

    ``loss_fn(model, rows, *inputs) -> scalar`` with ``rows`` the rank's
    (B/K, ..., D) pulled embeddings.  Every input is split along dim 0
    over the axis like the ids; the dense model is data-parallel over it
    (its gradients and the loss averaged over the ranks, in rank order).
    The row gradients of each rank's local loss go back to their owners
    (the all-gather that transposes the reduce-scatter), requests for one
    row summed, then ``table_optimizer`` updates only those rows:
    'adagrad' (the host table's formula: the accumulator over the mean
    square of the summed gradient, first, then ``w -= lr g / (sqrt(acc) +
    1e-6)``) or 'sgd'.  The table lives in the step (``_w``, ``_g2``, the
    rank's block); :meth:`sync_table` copies it back into the embedding's
    parameter.  ``device`` is where the step runs: the card unless the
    caller asks for the CPU; the model and the table must lie there."""

    def __init__(self, model, loss_fn, optimizer,
                 embedding: MeshShardedEmbedding, mesh=None,
                 table_optimizer: str = "adagrad", table_lr: float = 0.05,
                 donate: bool = True, device=None):
        if table_optimizer not in ("adagrad", "sgd"):
            raise ValueError(
                f"unsupported table optimizer {table_optimizer!r}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.embedding = embedding
        self.axis = embedding.mesh_axis
        self.mesh = mesh if mesh is not None else embedding.mesh
        if self.mesh is not None and self.axis not in self.mesh.shape:
            raise ValueError(f"mesh {dict(self.mesh.shape)} lacks the table "
                             f"axis {self.axis!r}")
        self.device = resolve_device(device)
        _require_on(self.device, model, embedding)
        self.k = _axis(self.mesh, self.axis)
        self.group = self.mesh.axis_group(self.axis) if self.k > 1 else None
        self.table_optimizer = table_optimizer
        self.table_lr = float(table_lr)
        self.donate = donate
        w = embedding.weight.detach()
        self._w = w.clone()
        self._g2 = torch.zeros(w.shape[0], dtype=torch.float32,
                               device=w.device)
        self._opt_states = None

    def _local(self, t):
        t = torch.as_tensor(t).to(self.device)
        return t if self.k == 1 else _local_slice(t, (self.axis,), self.mesh)

    def __call__(self, ids, *inputs):
        from paddle_tpu_torch.jit import (apply_functional_update,
                                          functional_loss_call)
        ids_l = self._local(ids)
        arrs = [self._local(i) for i in inputs]
        params = {n: p for n, p in self.model.named_parameters()
                  if p.requires_grad}
        if self._opt_states is None:
            self._opt_states = self.optimizer.functional_init_states(
                {n: p.detach() for n, p in params.items()})
        w, g = self._w, self.group
        rows_per = w.shape[0]
        ex = _Exchange(ids_l, rows_per, g, self.embedding.capacity)
        with torch.no_grad():
            mine = ex.back(ex.rows(w))
        # the dense net: loss and gradients of the params and pulled rows
        mine = mine.requires_grad_()
        with torch.enable_grad():
            loss = functional_loss_call(
                self.model, self.loss_fn, params, arrs,
                lead_tensors=(ex.per_slot(mine, ids_l.shape),))
            grads = torch.autograd.grad(
                loss, [*params.values(), mine], allow_unused=True)
        dmine = grads[-1]
        dparams = {n: torch.zeros_like(p) if d is None else d
                   for (n, p), d in zip(params.items(), grads[:-1])}
        loss = loss.detach()
        if g is not None:
            loss = mean_over(g, loss)
            dparams = {n: mean_over(g, d).to(d.dtype)
                       for n, d in dparams.items()}
        with torch.no_grad():
            self._push(ex, dmine, rows_per)
            lr = torch.full((), self.optimizer.get_lr(), dtype=torch.float32,
                            device=self.device)
            new_params, self._opt_states = apply_functional_update(
                self.optimizer, dparams,
                {n: p.detach() for n, p in params.items()},
                self._opt_states, lr, donate=self.donate)
            for n, p in params.items():
                if new_params[n].data_ptr() != p.data_ptr():
                    p.copy_(new_params[n])
        return loss

    def _push(self, ex: _Exchange, dmine: torch.Tensor, rows_per: int):
        """The reverse exchange and the touched-rows update (reference
        ``:409-440``)."""
        dall = dmine if ex.k == 1 else ex.group.all_gather(
            dmine.contiguous()).reshape(-1, dmine.shape[-1])
        dall = torch.where(ex.owned[:, None], dall, torch.zeros_like(dall))
        # requests for one row (from any rank) accumulate; not-owned ones
        # sort into a sentinel group past the rows, masked below
        sentinel = torch.where(ex.owned, ex.clipped,
                               torch.full_like(ex.clipped, rows_per))
        uniq2, inv2 = _sort_dedup(sentinel)
        acc = torch.zeros_like(dall).index_add_(0, inv2, dall)
        valid = uniq2 < rows_per
        tgt = torch.where(valid, uniq2, torch.zeros_like(uniq2))
        contrib = torch.where(valid[:, None], acc, torch.zeros_like(acc))
        lr = self.table_lr
        if self.table_optimizer == "adagrad":
            gsq = (contrib ** 2).mean(dim=1)
            self._g2.index_add_(0, tgt, torch.where(valid, gsq,
                                                    torch.zeros_like(gsq)))
            denom = torch.sqrt(self._g2[tgt])[:, None] + 1e-6
            self._w.index_add_(0, tgt, (-lr * contrib) / denom)
        else:
            self._w.index_add_(0, tgt, -lr * contrib)

    def sync_table(self):
        """Copy the step's table into the embedding's parameter (the rank's
        block) and return the parameter."""
        with torch.no_grad():
            self.embedding.weight.copy_(self._w)
        return self.embedding.weight


def _require_on(device: torch.device, *modules):
    """Raise unless every parameter of ``modules`` lies on ``device``."""
    for m in modules:
        for n, p in m.named_parameters():
            if p.device.type != device.type:
                raise ValueError(f"{type(m).__name__}.{n} lies on "
                                 f"{p.device}, the step runs on {device}")
