"""The parameter server's in-process tiers (port of paddle_tpu/
distributed/ps/__init__.py and device_table.py).

The reference maps the PS onto three tiers; the port has each, run inside
one process (its ranks ``LoopbackWorld`` threads or processes of a
``torch.distributed`` group):

- **device tier**, :class:`ShardedEmbedding`: the table is a dense
  parameter of the model, its gradient dense (the reference's Adam under
  ``TrainStep`` moves every row's moments, and ``sparse=True`` is read by
  nothing); at ``mp`` > 1 each rank holds its row block;
- **device exchange tier**, :class:`MeshShardedEmbedding` and
  :class:`DeviceEmbeddingTrainStep` (``device_table.py``): the table
  range-sharded over a mesh axis with an explicit dedup and exchange and
  a touched-rows-only adagrad;
- **host tier**, :class:`HostEmbeddingTable` (and the dynamic-vocabulary
  :class:`HashEmbeddingTable`) in host numpy with the reference's exact
  draws and update formulas, :class:`AsyncCommunicator` (sync, async on a
  worker thread, geo folds every k steps), :class:`DistributedEmbedding`
  (pull in the forward, push from a hook on the pulled leaf) and
  :class:`PSTrainStep`, the worker's pull, dense step and push, with a
  prefetch pipeline; the host tables served over TCP by ``ps.service``
  (``PsServer``, ``PsClient``, ``RemoteEmbeddingTable``), and the graph
  table ``ps.graph``.

A table that takes the same pushes as the reference's is bitwise equal to
it.  No Pallas kernel lies on these tiers: the reference computes them
with XLA gathers, scatters and collectives, the port with PyTorch tensor
ops and the mesh's collectives.

The host planes see ``PSTrainStep`` as the reference's (``:593-894``): a
``train.step`` span per call, a detached ``ps.prefetch`` span per
background pull (closed "ok" when a step takes its rows, with an error and
its reason when the rows are discarded), ``ps_prefetch_hits_total`` /
``ps_prefetch_misses_total`` and the ``ps_prefetch_miss`` health signal,
the ``PSTrainStep`` compile site, and the ``ps.pipeline`` fault point at
the head of each prefetch: a failed prefetch makes the step replay its
push and pull synchronously, so every gradient reaches the table once and
in order (the synchronous pull comes after the previous step's deferred
push, which the prefetch's pull would have preceded, as in the
reference).  The host tables take tracked locks
(``ps.host_table``, ``ps.dynamic_table``).

Over a remote table (one with ``push_pull``) the deferred push rides the
pull's RPC, stamped once with a dedup ``seq`` that any replay re-sends and
linked to the step spans that produced it; a prefetch issued under an
older membership epoch than the client's at consume time is discarded and
pulled again (``reason="stale_epoch"``), a coalesced push the server's
epoch fence rejected stays dropped, and any other failure replays the
push synchronously.  With a local table a prefetch pushes, then pulls.
The reference's ``numerics``, ``incident`` and ``autopilot`` hooks are
here: the numerics record of the dense leaves and the pulled rows, the
incident ring of the pulled ids and the dense batch, and the tuned
profile applied at construction; none changes a result.
"""
from __future__ import annotations

import importlib
import queue
import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.distributed.tp_layers import vocab_lookup
from paddle_tpu_torch.distributed.ps.device_table import (
    DeviceEmbeddingTrainStep, HotRowSketch, MeshShardedEmbedding,
    _require_on, clamped_rows, gather_rows, init_table, mesh_sharded_lookup)
from paddle_tpu_torch.framework import chaos, health, locks, monitor, numerics
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.framework.observability import tracer
from paddle_tpu_torch.framework.parameter import Parameter
from paddle_tpu_torch.jit import not_to_static
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.parallel import tp
from paddle_tpu_torch.parallel.mesh import DistAttr, current_mesh

__all__ = ["HashEmbeddingTable", "MeshShardedEmbedding",
           "DeviceEmbeddingTrainStep", "HotRowSketch",
           "ShardedEmbedding", "HostEmbeddingTable", "DistributedEmbedding",
           "AsyncCommunicator", "PSTrainStep", "mesh_sharded_lookup"]



def __getattr__(name):
    # the transport and the graph table import this module: load on use
    if name in ("service", "graph"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class ShardedEmbedding(Layer):
    """An embedding whose rows the reference shards over ``mesh_axis``
    (``DistAttr((mesh_axis, None))``, the capacity path; reference
    ``:59-81``).  The table is ``default_rng(0).uniform(-std, std, (V,
    E))`` with std = 1 / max(1, sqrt(E)), whatever the layer; the lookup
    is the reference's ``w[ids]`` (a negative id counts from the end, one
    past the table reads the last row and passes no gradient) and its
    gradient dense.

    Where ``mesh_axis`` is ``mp`` and the mesh (``mesh``, else the active
    one; or given by :meth:`apply_mesh`, as ``ShardedTrainStep`` does) has
    m > 1 ``mp`` ranks, each rank holds its block of V/m rows, as
    ``VocabParallelEmbedding`` does: a masked local gather summed over
    ``mp`` in rank order, where only the owner adds a non-zero, so the
    rows are bitwise the one-rank gather's.  Over any other axis (``dp``,
    ``sharding``, ...) the port keeps the whole table on every rank: a
    replica whose gradient the data-parallel step averages, the same
    result as the reference's partitioned gather."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 mesh_axis: str = "mp", sparse: bool = True,
                 weight_attr=None, name=None, scale_grad_by_freq=False,
                 device=None, mesh=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.mesh_axis = mesh_axis
        std = 1.0 / max(1.0, embedding_dim ** 0.5)
        init = np.random.default_rng(0).uniform(
            -std, std, size=(num_embeddings, embedding_dim)).astype(
                np.float32)
        self.weight = Parameter(torch.from_numpy(init).to(
            resolve_device(device)), name=name or "sharded_embedding")
        self.weight.dist_attr = DistAttr((mesh_axis, None))
        self._group = None
        mesh = mesh if mesh is not None else current_mesh()
        if mesh is not None:
            self.apply_mesh(mesh)

    def apply_mesh(self, mesh) -> "ShardedEmbedding":
        """Hold this rank's row block where ``mesh_axis`` is ``mp`` and the
        mesh has m > 1 of it (once; a second mesh must have the same m)."""
        m = mesh.shape.get("mp", 1) if self.mesh_axis == "mp" else 1
        if m == 1:
            return self
        if self._group is not None:
            if self._group.size != m:
                raise ValueError(f"ShardedEmbedding holds {self._group.size}"
                                 f" row blocks, the mesh has mp={m}")
            return self
        if self._num_embeddings % m:
            raise ValueError(f"ShardedEmbedding at mp={m}: num_embeddings="
                             f"{self._num_embeddings} does not divide by {m}")
        tp.shard_parameter(self.weight, tp.Split(0), m,
                           mesh.axis_index("mp"))
        self._group = mesh.axis_group("mp")
        return self

    def forward(self, x):
        ids = torch.as_tensor(x, device=self.weight.device).long()
        if self._group is None:
            return clamped_rows(self.weight, ids)
        V = self._num_embeddings
        ids = torch.where(ids < 0, ids + V, ids)
        valid = ((ids >= 0) & (ids < V))[..., None]
        out = vocab_lookup(self.weight, ids.clamp(0, V - 1), self._group)
        return torch.where(valid, out, out.detach())


class HostEmbeddingTable:
    """A host-RAM sparse table with its optimizer applied on push
    (reference ``:84-155``): rows drawn at construction (float32
    ``rng.random`` scaled in place, no float64 temporary: a 100M x 65
    table is 26 GB), 'sgd' or 'adagrad' (a per-row accumulator of the mean
    square of the summed gradient).  Thread-safe."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 optimizer: str = "adagrad", learning_rate: float = 0.05,
                 initializer_range: float = 0.05, seed: int = 0):
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self._table = init_table(num_embeddings, embedding_dim,
                                 initializer_range, seed)
        if optimizer == "adagrad":
            self._g2 = np.zeros((num_embeddings,), np.float32)
        elif optimizer != "sgd":
            raise ValueError(f"unsupported table optimizer {optimizer!r}")
        self._lock = locks.lock("ps.host_table")
        k = int(flag("ps_hot_row_k"))
        self.hot_rows = HotRowSketch(k) if k > 0 else None

    def pull(self, ids: np.ndarray) -> np.ndarray:
        """The rows of ``ids`` (a copy)."""
        if self.hot_rows is not None:
            self.hot_rows.update(ids)
        with self._lock:
            return self._table[ids]

    def push(self, ids: np.ndarray, grads: np.ndarray,
             lr: Optional[float] = None):
        """Apply row gradients with the table's optimizer; duplicate ids
        are summed first (``np.unique`` and ``np.add.at``)."""
        lr = self.learning_rate if lr is None else lr
        flat_ids = ids.reshape(-1)
        flat_g = grads.reshape(-1, self.embedding_dim)
        uniq, inv = np.unique(flat_ids, return_inverse=True)
        acc = np.zeros((len(uniq), self.embedding_dim), np.float32)
        np.add.at(acc, inv, flat_g)
        with self._lock:
            if self.optimizer == "adagrad":
                self._g2[uniq] += (acc ** 2).mean(axis=1)
                denom = np.sqrt(self._g2[uniq])[:, None] + 1e-6
                self._table[uniq] -= lr * acc / denom
            else:
                self._table[uniq] -= lr * acc

    def state_dict(self) -> Dict[str, np.ndarray]:
        d = {"table": self._table, "optimizer": self.optimizer}
        if self.optimizer == "adagrad":
            d["g2"] = self._g2
        return d

    def set_state_dict(self, d):
        self._table = np.asarray(d["table"], np.float32)
        if self.optimizer == "adagrad" and "g2" in d:
            self._g2 = np.asarray(d["g2"], np.float32)


class AsyncCommunicator:
    """Push batching (reference ``:158-284``): 'sync' applies a push at
    once, 'async' on a worker thread, 'geo' sums the pushes and folds them
    into the table every ``k_steps``.

    The async worker holds only weak references to the communicator and
    its table, so a dropped communicator does not pin a table of tens of
    GB; it exits once the communicator is collected or :meth:`stop` is
    called.  Flush before drop: if the communicator is collected with
    pushes still queued, the worker applies them only where the table is
    alive elsewhere; where both die together (the usual
    ``DistributedEmbedding`` case) they are dropped.  Call :meth:`flush`
    (or :meth:`stop`) first whenever every gradient must land."""

    def __init__(self, table, mode: str = "async", k_steps: int = 4,
                 send_queue_size: int = 16):
        if mode not in ("async", "geo", "sync"):
            raise ValueError(f"unknown communicator mode {mode!r}")
        self.table = table
        self.mode = mode
        self.k_steps = k_steps
        self._q: "queue.Queue" = queue.Queue(maxsize=send_queue_size)
        self._geo_acc: Dict[int, np.ndarray] = {}
        self._geo_count = 0
        self._stop = threading.Event()
        self._thread = None
        if mode == "async":
            self._thread = threading.Thread(
                target=AsyncCommunicator._worker_loop,
                args=(weakref.ref(self), weakref.ref(table)), daemon=True)
            self._thread.start()

    @staticmethod
    def _drain_queue(q: "queue.Queue", table):
        """Apply every queued push to ``table`` (nothing when it is
        gone)."""
        while table is not None:
            try:
                ids, grads = q.get_nowait()
            except queue.Empty:
                return
            try:
                table.push(ids, grads)
            finally:
                q.task_done()

    @staticmethod
    def _worker_loop(comm_ref, table_ref):
        comm = comm_ref()
        if comm is None:
            return
        q, stop = comm._q, comm._stop      # these pin neither object
        del comm
        while True:
            if stop.is_set():
                return
            try:
                ids, grads = q.get(timeout=0.05)
            except queue.Empty:
                if comm_ref() is None:
                    AsyncCommunicator._drain_queue(q, table_ref())
                    return
                continue
            comm = comm_ref()
            if comm is None:
                table = table_ref()
                try:
                    if table is not None:
                        table.push(ids, grads)
                finally:
                    q.task_done()
                AsyncCommunicator._drain_queue(q, table)
                return
            try:
                comm.table.push(ids, grads)
            finally:
                q.task_done()          # or flush() would wait forever
            del comm                   # do not pin the table across a wait

    def push(self, ids: np.ndarray, grads: np.ndarray):
        """Queue (async), sum (geo) or apply (sync) a gradient push."""
        if self.mode == "sync":
            self.table.push(ids, grads)
        elif self.mode == "async":
            self._q.put((ids, grads))
        else:
            flat_ids = ids.reshape(-1)
            flat_g = grads.reshape(-1, self.table.embedding_dim)
            for i, g in zip(flat_ids.tolist(), flat_g):
                if i in self._geo_acc:
                    self._geo_acc[i] = self._geo_acc[i] + g
                else:
                    self._geo_acc[i] = g.copy()
            self._geo_count += 1
            if self._geo_count >= self.k_steps:
                self.flush()

    def flush(self):
        if self.mode == "async":
            self._q.join()
        elif self.mode == "geo" and self._geo_acc:
            ids = np.asarray(list(self._geo_acc), np.int64)
            grads = np.stack(list(self._geo_acc.values()))
            self.table.push(ids, grads)
            self._geo_acc.clear()
            self._geo_count = 0

    def stop(self):
        self.flush()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class DistributedEmbedding(Layer):
    """A layer over a host table (reference ``:287-328``): the forward
    pulls the rows of its ids on the host and returns them as a leaf on
    ``device`` (the card unless the caller asks for the CPU) that requires
    grad; a hook on that leaf pushes its gradient rows through the
    communicator when the backward reaches it."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 optimizer: str = "adagrad", learning_rate: float = 0.05,
                 mode: str = "sync", k_steps: int = 4, seed: int = 0,
                 table=None, device=None):
        super().__init__()
        self.table = table if table is not None else HostEmbeddingTable(
            num_embeddings, embedding_dim, optimizer, learning_rate,
            seed=seed)
        self.communicator = AsyncCommunicator(self.table, mode=mode,
                                              k_steps=k_steps)
        self._embedding_dim = embedding_dim
        self.device = resolve_device(device)

    @not_to_static
    def forward(self, x):
        ids = np.asarray(x.detach().cpu().numpy()
                         if isinstance(x, torch.Tensor) else x, np.int64)
        rows = self.table.pull(ids)
        out = torch.from_numpy(rows).to(self.device).requires_grad_()
        comm = self.communicator

        def push_hook(grad):
            comm.push(ids, grad.detach().float().cpu().numpy())
            return grad

        out.register_hook(push_hook)
        return out

    def flush(self):
        self.communicator.flush()


class HashEmbeddingTable:
    """A dynamic-vocabulary sparse table (reference ``:331-425``): a row
    exists once touched, drawn from a per-id seed (``default_rng((seed *
    0x9E3779B9 + id) & 0xFFFFFFFF)``), so any id of int64 (hashes
    included) names the same row on any shard and restart.  The pull /
    push surface of :class:`HostEmbeddingTable`."""

    def __init__(self, embedding_dim: int, optimizer: str = "adagrad",
                 learning_rate: float = 0.05,
                 initializer_range: float = 0.05, seed: int = 0):
        self.num_embeddings = 0            # grows on touch
        self.embedding_dim = embedding_dim
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self._init_range = initializer_range
        self._seed = seed
        if optimizer not in ("adagrad", "sgd"):
            raise ValueError(f"unsupported table optimizer {optimizer!r}")
        self._rows: Dict[int, np.ndarray] = {}
        self._g2: Dict[int, float] = {}
        self._lock = locks.lock("ps.dynamic_table")
        k = int(flag("ps_hot_row_k"))
        self.hot_rows = HotRowSketch(k) if k > 0 else None

    def _row(self, i: int) -> np.ndarray:
        r = self._rows.get(i)
        if r is None:
            rng = np.random.default_rng((self._seed * 0x9E3779B9 + i)
                                        & 0xFFFFFFFF)
            r = rng.uniform(-self._init_range, self._init_range,
                            self.embedding_dim).astype(np.float32)
            self._rows[i] = r
            self.num_embeddings = len(self._rows)
        return r

    def pull(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        flat = ids.reshape(-1)
        if self.hot_rows is not None:
            self.hot_rows.update(flat)
        with self._lock:
            out = np.stack([self._row(int(i)) for i in flat])
        return out.reshape(ids.shape + (self.embedding_dim,))

    def push(self, ids: np.ndarray, grads: np.ndarray, lr=None):
        lr = self.learning_rate if lr is None else lr
        flat = np.asarray(ids, np.int64).reshape(-1)
        g = np.asarray(grads, np.float32).reshape(flat.size,
                                                  self.embedding_dim)
        uniq, inv = np.unique(flat, return_inverse=True)
        acc = np.zeros((uniq.size, self.embedding_dim), np.float32)
        np.add.at(acc, inv, g)
        with self._lock:
            for k, i in enumerate(uniq.tolist()):
                row = self._row(i)
                if self.optimizer == "adagrad":
                    self._g2[i] = self._g2.get(i, 0.0) + float(
                        (acc[k] ** 2).mean())
                    row -= lr * acc[k] / (np.sqrt(self._g2[i]) + 1e-6)
                else:
                    row -= lr * acc[k]

    def state_dict(self):
        """{"ids", "table", "optimizer"} (and "g2" aligned with ids)."""
        with self._lock:
            ids = np.fromiter(self._rows.keys(), np.int64,
                              count=len(self._rows))
            table = (np.stack([self._rows[int(i)] for i in ids])
                     if ids.size else
                     np.zeros((0, self.embedding_dim), np.float32))
            d = {"ids": ids, "table": table, "optimizer": self.optimizer}
            if self.optimizer == "adagrad":
                d["g2"] = np.asarray([self._g2.get(int(i), 0.0)
                                      for i in ids], np.float32)
            return d

    def set_state_dict(self, d):
        with self._lock:
            self._rows = {int(i): np.asarray(r, np.float32)
                          for i, r in zip(d["ids"], d["table"])}
            if "g2" in d:
                self._g2 = {int(i): float(v)
                            for i, v in zip(d["ids"], d["g2"])}
            self.num_embeddings = len(self._rows)


def bf16_rows(rows: np.ndarray) -> torch.Tensor:
    """f32 rows rounded to bfloat16 on the host, to nearest even (the
    reference's ``astype(ml_dtypes.bfloat16)``)."""
    return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(
        torch.bfloat16)


class PSTrainStep:
    """The parameter-server worker's cycle (reference ``:427-956``): pull
    the rows of the batch's unique ids from the host table, run the dense
    net's forward, backward and update on the card with the gradient of
    the pulled rows, and push those gradients back to the host.

    ``loss_fn(model, rows, *inputs) -> scalar`` with ``rows`` the (B, F,
    E) pulled rows.  Only the unique ids travel (``_unique_prep``: padded
    with id 0 to a power of two of at least 256); the rows go to the card
    in bfloat16 where ``transfer_dtype`` says so (rounded on the host),
    are re-gathered per slot in f32 there (the gather's backward sums a
    duplicate id's gradients), and the gradient of the unique rows is
    taken in their transfer dtype, as the reference differentiates with
    respect to its bf16 ``rows_u``, before it goes back in f32.

    The pipeline: :meth:`prefetch` announces an upcoming batch's ids;
    right after a step's work is queued on the card the announced pull
    runs on a background thread, after the previous step's push, so rows
    pulled for step N + 1 reflect every push up to step N - 1
    (``prefetch_depth``, ``FLAGS_ps_prefetch_depth``, bounds the pulls in
    flight; 0 turns the pipeline off).  A remote table's ``push_pull``
    carries the push and the pull in one RPC a shard, also on the
    synchronous path.  Unpipelined, each step's push goes through the
    embedding's communicator.  :meth:`flush` drains both.

    ``device`` is where the dense step runs: the card unless the caller
    asks for the CPU; the model must lie there.  The step runs through
    ``jit.functional_loss_call(..., lead_tensors=(rows,))`` and
    ``jit.apply_functional_update``."""

    def __init__(self, model, loss_fn, optimizer,
                 embedding: DistributedEmbedding, donate: bool = True,
                 transfer_dtype="bfloat16",
                 prefetch_depth: Optional[int] = None, device=None):
        # the tuned profile first: the prefetch_depth default below reads
        # the flag the profile may set (reference :491-494)
        from paddle_tpu_torch.framework.autopilot import \
            maybe_apply_tuned_profile
        maybe_apply_tuned_profile(source="PSTrainStep")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.embedding = embedding
        self.donate = donate
        self.transfer_dtype = str(transfer_dtype)
        self.prefetch_depth = int(flag("ps_prefetch_depth")) \
            if prefetch_depth is None else int(prefetch_depth)
        self.device = resolve_device(device)
        _require_on(self.device, model)
        self._opt_states = None
        self._announced: "deque" = deque()   # ids awaiting issue
        self._inflight: "deque" = deque()    # issued background pulls
        # deferred (uniq ids, grads) pushes: a queue, so that a step with
        # nothing left to issue does not drop the previous one's
        self._pending_push: list = []
        self._prefetch_pool = None
        self._signatures: set = set()

    @staticmethod
    def _unique_prep(ids_np):
        """(unique ids, inverse map, the unique ids padded with 0 to a
        power of two of at least 256)."""
        uniq, inv = np.unique(ids_np.reshape(-1), return_inverse=True)
        cap = max(256, 1 << int(np.ceil(np.log2(len(uniq)))))
        uniq_p = np.zeros((cap,), np.int64)
        uniq_p[:len(uniq)] = uniq
        return uniq, inv, uniq_p

    def set_prefetch_depth(self, depth: int) -> int:
        """Set the pipeline's depth; returns the previous one."""
        prev = self.prefetch_depth
        self.prefetch_depth = max(0, int(depth))
        if self._prefetch_pool is not None and not self._inflight \
                and self.prefetch_depth != prev:
            self._prefetch_pool.shutdown(wait=True)
            self._prefetch_pool = None
        return prev

    def prefetch(self, ids):
        """Announce the ids of an upcoming batch (nothing when the
        pipeline is off)."""
        if self.prefetch_depth <= 0:
            return
        self._announced.append(_ids_np(ids))

    def _client(self):
        return getattr(self.embedding.table, "client", None)

    def _tracer(self):
        """The PS client's tracer (so step and RPC spans share a file), or
        the process's."""
        t = getattr(self._client(), "tracer", None)
        return t if t is not None else tracer

    @staticmethod
    def _push_links(push):
        """A ``deferred_push`` link to each step span whose gradient the
        push carries, for the RPC span that carries it (None without)."""
        if push is None or not push[3]:
            return None
        return [{"span": sid, "kind": "deferred_push"} for sid in push[3]]

    def _push_pull(self, table, push, uniq_p):
        """The deferred push and the pull: one ``push_pull`` where the
        table has it, else the push (replayed with its stamp), then the
        pull."""
        if push is not None and hasattr(table, "push_pull"):
            return table.push_pull(push[0], push[1], uniq_p, seq=push[2],
                                   links=self._push_links(push))
        if push is not None:
            self._replay_push(push)
        return table.pull(uniq_p)

    def _replay_push(self, push):
        """Send a deferred push; to a remote table with its original stamp,
        so the server drops it where an earlier attempt landed."""
        table = self.embedding.table
        if self._client() is not None and push[2] is not None:
            table.push(push[0], push[1], seq=push[2],
                       links=self._push_links(push))
        else:
            table.push(push[0], push[1])

    def _prefetch_task(self, table, ids_np, push, span=None):
        """The background pull (after the deferred push), under the
        ``ps.prefetch`` span opened when it was issued."""
        with self._tracer().activate(
                span.context() if span is not None else None):
            chaos.fault_point("ps.pipeline",
                              meta={"n_ids": int(ids_np.size),
                                    "coalesced_push": push is not None})
            uniq, inv, uniq_p = self._unique_prep(ids_np)
            rows = self._push_pull(table, push, uniq_p)
            if span is not None:
                # when the work finished (epoch us): the span stays open
                # until a step takes the rows
                span.set_attr("done_ts", time.time() * 1e6)
            return uniq, inv, uniq_p, rows

    def _take_pending_push(self):
        """The deferred pushes as one (ids, grads, seq, producing step
        span ids), or None.  A remote table's dedup ``seq`` is drawn here,
        once, so a replay re-sends it."""
        if not self._pending_push:
            return None
        if len(self._pending_push) == 1:
            ids_p, g_p = self._pending_push[0][:2]
        else:
            ids_p = np.concatenate([p[0] for p in self._pending_push])
            g_p = np.concatenate([p[1] for p in self._pending_push])
        sids = [p[2] for p in self._pending_push if p[2] is not None]
        self._pending_push.clear()
        client = self._client()
        seq = client._next_seq() if client is not None else None
        return ids_p, g_p, seq, sids

    def _issue_prefetch(self):
        while (self.prefetch_depth > 0 and self._announced
               and len(self._inflight) < self.prefetch_depth):
            ids_np = self._announced.popleft()
            push = self._take_pending_push()
            if self._prefetch_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._prefetch_pool = ThreadPoolExecutor(
                    max_workers=max(1, self.prefetch_depth),
                    thread_name_prefix="ps-prefetch")
            # the span covers the whole flight, issue to settle
            span = self._tracer().start_span(
                "ps.prefetch", detached=True,
                attrs={"n_ids": int(ids_np.size),
                       "coalesced_push": push is not None})
            span = span if span.span_id is not None else None
            self._inflight.append({
                "key": ids_np, "push": push, "span": span,
                "epoch": getattr(self._client(), "epoch", None),
                "future": self._prefetch_pool.submit(
                    self._prefetch_task, self.embedding.table, ids_np, push,
                    span)})

    @staticmethod
    def _end_prefetch_span(inf, status, **attrs):
        if inf["span"] is not None:
            inf["span"].end(status=status, **attrs)

    def _settle_inflight(self, inf):
        """The prefetch's result, or None when it failed (reference
        ``:685-718``): its push is then replayed synchronously with its
        stamp (the server drops a copy that landed), except a push the
        epoch fence rejected, which stays dropped."""
        try:
            return inf["future"].result()
        except RuntimeError as e:
            self._end_prefetch_span(inf, "error", reason="server_error",
                                    exc=repr(e))
            if "stale membership epoch" in str(e):
                return None
        except (ConnectionError, OSError) as e:
            self._end_prefetch_span(inf, "error", reason="transport",
                                    exc=repr(e))
        if inf["push"] is not None:
            self._replay_push(inf["push"])
        return None

    @staticmethod
    def _link_prefetch(inf, step_span, kind):
        if inf["span"] is not None and step_span is not None:
            step_span.link(inf["span"].span_id, kind)

    def _miss(self, inf, step_span):
        self._link_prefetch(inf, step_span, "sync_fallback")
        monitor.stat_add("ps_prefetch_misses_total")
        health.observe("ps_prefetch_miss", 1.0)

    def _consume_prefetch(self, ids_np, step_span=None):
        """The head prefetch's (uniq, inv, uniq_p, rows) for this batch, or
        None: pull synchronously (nothing prefetched, the prefetch failed,
        another batch's rows, or rows of an older membership epoch).  The
        step's span links to the prefetch either way."""
        if not self._inflight:
            # the announcement may be this batch's own (the warm-up call
            # before the first step): drop it
            if self._announced and np.array_equal(self._announced[0],
                                                  ids_np):
                self._announced.popleft()
            return None
        inf = self._inflight.popleft()
        got = self._settle_inflight(inf)
        if got is None:                # the settle closed the span
            self._miss(inf, step_span)
            return None
        if not np.array_equal(inf["key"], ids_np):
            self._end_prefetch_span(inf, "error", reason="reordered")
            self._miss(inf, step_span)
            return None
        client = self._client()
        if client is not None and inf["epoch"] != client.epoch:
            self._end_prefetch_span(inf, "error", reason="stale_epoch",
                                    issued_epoch=inf["epoch"],
                                    epoch=client.epoch)
            self._miss(inf, step_span)
            return None
        self._end_prefetch_span(inf, "ok")
        self._link_prefetch(inf, step_span, "prefetch")
        monitor.stat_add("ps_prefetch_hits_total")
        health.observe("ps_prefetch_miss", 0.0)
        return got

    def __call__(self, ids, *inputs):
        # the postmortem ring: the pulled ids are the sparse tier's step
        # input (reference :822-826); one flag lookup disarmed
        from paddle_tpu_torch.framework import incident
        incident.maybe_note(self, (ids,) + tuple(inputs))
        t_start = time.perf_counter()
        step_span = self._tracer().start_span(
            "train.step",
            attrs={"step": int(getattr(self.optimizer, "_global_step", 0))})
        with step_span:
            loss = self._call_inner(ids, step_span, *inputs)
        step_ms = (time.perf_counter() - t_start) * 1e3
        monitor.observe("train_step_ms", step_ms)
        monitor.stat_add("train_steps_total")
        health.observe("train_step_ms", step_ms)
        return loss

    def _call_inner(self, ids, step_span, *inputs):
        from paddle_tpu_torch.jit import (apply_functional_update,
                                          functional_loss_call)
        ids_np = _ids_np(ids)
        got = self._consume_prefetch(ids_np, step_span)
        pipelined = got is not None
        table = self.embedding.table
        if got is None:
            uniq, inv, uniq_p = self._unique_prep(ids_np)
            rows_u = self._push_pull(table, self._take_pending_push(),
                                     uniq_p)
        else:
            uniq, inv, uniq_p, rows_u = got
        dev = self.device
        if self.transfer_dtype in ("bfloat16", "bf16"):
            rows_t = bf16_rows(rows_u)
        else:
            rows_t = torch.from_numpy(np.ascontiguousarray(rows_u))
        arrs = [torch.as_tensor(i).to(dev) for i in inputs]
        armed = numerics.enabled()
        # the reference's cache key (:870-880): a new one is a compile
        sig = (tuple(rows_t.shape), str(rows_t.dtype).replace("torch.", ""),
               ids_np.shape, tuple((tuple(a.shape),
                                    str(a.dtype).replace("torch.", ""))
                                   for a in arrs)) \
            + (("numerics",) if armed else ())
        cause = None
        if sig in self._signatures:
            health.note_cache_hit("PSTrainStep")
        else:
            cause = health.classify_recompile(sig, list(self._signatures))
            self._signatures.add(sig)
        with health.timed_compile("PSTrainStep", cause):
            rows_d = rows_t.to(dev, non_blocking=True).requires_grad_()
            inv_d = torch.from_numpy(inv.reshape(-1)).to(dev,
                                                         non_blocking=True)
            params = {n: p for n, p in self.model.named_parameters()
                      if p.requires_grad}
            if self._opt_states is None:
                self._opt_states = self.optimizer.functional_init_states(
                    {n: p.detach() for n, p in params.items()})
            with torch.enable_grad():
                rows = gather_rows(rows_d.float(), inv_d).reshape(
                    ids_np.shape + (rows_d.shape[-1],))
                loss = functional_loss_call(self.model, self.loss_fn, params,
                                            arrs, lead_tensors=(rows,))
                grads = torch.autograd.grad(
                    loss, [*params.values(), rows_d], allow_unused=True)
            dparams = {n: torch.zeros_like(p) if g is None else g
                       for (n, p), g in zip(params.items(), grads[:-1])}
            with torch.no_grad():
                lr = torch.full((), self.optimizer.get_lr(),
                                dtype=torch.float32, device=dev)
                before = {n: p.detach() for n, p in params.items()}
                if armed and self.donate:
                    before = {n: t.clone() for n, t in before.items()}
                new_params, self._opt_states = apply_functional_update(
                    self.optimizer, dparams,
                    {n: p.detach() for n, p in params.items()},
                    self._opt_states, lr, donate=self.donate)
                for n, p in params.items():
                    if new_params[n].data_ptr() != p.data_ptr():
                        p.copy_(new_params[n])
                aux = None
                if armed:
                    # the pulled rows are a leaf of the numerics view
                    # (reference :799-812): their update happens on the
                    # host table, so their update term is an exact zero
                    rows_f = rows_d.detach().float()
                    aux = numerics.compute_aux(
                        {**dparams, "embedding.rows": grads[-1]},
                        {**before, "embedding.rows": rows_f},
                        {**new_params, "embedding.rows": rows_f}, loss)
        # the card is busy until the gradient's read below: the announced
        # next pull (after the previous push) runs meanwhile
        self._issue_prefetch()
        if aux is not None:
            rec = numerics.NumericsRecord(
                list(params) + ["embedding.rows"], aux,
                step=int(getattr(self.optimizer, "_global_step", 0)))
            numerics.publish(rec)
            self.last_numerics = rec
        grads_host = grads[-1][:len(uniq)].float().cpu().numpy()
        if self.prefetch_depth > 0 and (pipelined or self._inflight
                                        or self._announced):
            self._pending_push.append((uniq, grads_host,
                                       step_span.span_id))
        else:
            self.embedding.communicator.push(uniq, grads_host)
        return loss.detach()

    def flush(self):
        """Land every push: the prefetches in flight (each carrying a
        push), the deferred pushes, then the communicator's queue."""
        self._announced.clear()
        while self._inflight:
            inf = self._inflight.popleft()
            if self._settle_inflight(inf) is not None:
                self._end_prefetch_span(inf, "ok", drained=True)
        while self._pending_push:
            self.embedding.table.push(*self._pending_push.pop(0)[:2])
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=True)
            self._prefetch_pool = None
        self.embedding.flush()


def _ids_np(ids) -> np.ndarray:
    return np.asarray(ids.detach().cpu().numpy()
                      if isinstance(ids, torch.Tensor) else ids, np.int64)
