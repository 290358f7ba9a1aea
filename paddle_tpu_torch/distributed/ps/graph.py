"""The parameter server's graph table (port of paddle_tpu/distributed/ps/
graph.py; plain numpy, as the reference's).

:class:`GraphTable` keeps adjacency lists and node features on the host
and samples neighbours there; what it returns is rectangular (neighbour
ids (B, k) padded with -1, counts (B,)), so the aggregation runs on the
card (``tensor.sequence``'s segment ops).  Sampling makes the reference's
``default_rng(seed).choice`` calls in its order, so a table built and
queried the same way draws the same samples.  A :class:`PsServer` serves
one under its ``graph`` op; :class:`RemoteGraphTable` is the query
surface over a ``PsClient``, node ids routed by ``id % n``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["GraphTable", "RemoteGraphTable"]


class GraphTable:
    """Adjacency lists and node features in host memory."""

    def __init__(self, embedding_dim: int = 0, seed: int = 0):
        self.embedding_dim = embedding_dim
        self._adj: Dict[int, list] = {}
        self._feat: Dict[int, np.ndarray] = {}
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._frozen: Optional[Dict[int, np.ndarray]] = None

    # -- construction -------------------------------------------------------
    def add_edges(self, src: Sequence[int], dst: Sequence[int],
                  bidirectional: bool = False):
        with self._lock:
            self._frozen = None
            for s, d in zip(np.asarray(src).tolist(),
                            np.asarray(dst).tolist()):
                self._adj.setdefault(int(s), []).append(int(d))
                if bidirectional:
                    self._adj.setdefault(int(d), []).append(int(s))

    def set_node_feat(self, ids: Sequence[int], feats: np.ndarray):
        feats = np.asarray(feats, np.float32)
        with self._lock:
            for i, f in zip(np.asarray(ids).tolist(), feats):
                self._feat[int(i)] = f

    def _neighbors(self, node: int) -> np.ndarray:
        if self._frozen is None:
            self._frozen = {k: np.asarray(v, np.int64)
                            for k, v in self._adj.items()}
        return self._frozen.get(node, np.empty(0, np.int64))

    # -- queries ------------------------------------------------------------
    def sample_neighbors(self, ids: np.ndarray, sample_size: int,
                         replace: bool = False):
        """(B,) node ids -> (neighbours (B, sample_size) padded with -1,
        counts (B,)); without replacement a node of lower degree gives
        all its neighbours, in a random order."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        out = np.full((ids.size, sample_size), -1, np.int64)
        counts = np.zeros((ids.size,), np.int64)
        with self._lock:
            for r, node in enumerate(ids.tolist()):
                nbrs = self._neighbors(node)
                if nbrs.size == 0:
                    continue
                if replace or nbrs.size < sample_size:
                    take = self._rng.choice(
                        nbrs, size=min(sample_size, nbrs.size)
                        if not replace else sample_size, replace=replace)
                else:
                    take = self._rng.choice(nbrs, size=sample_size,
                                            replace=False)
                out[r, :take.size] = take
                counts[r] = take.size
        return out, counts

    def get_node_feat(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        dim = self.embedding_dim or (
            next(iter(self._feat.values())).shape[0] if self._feat else 0)
        out = np.zeros((ids.size, dim), np.float32)
        with self._lock:
            for r, node in enumerate(ids.tolist()):
                f = self._feat.get(node)
                if f is not None:
                    out[r] = f
        return out

    def random_sample_nodes(self, n: int) -> np.ndarray:
        with self._lock:
            nodes = np.fromiter(self._adj.keys(), np.int64,
                                count=len(self._adj))
        if nodes.size == 0:
            return np.empty(0, np.int64)
        return self._rng.choice(nodes, size=min(n, nodes.size),
                                replace=False)

    def degree(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            return np.asarray([len(self._adj.get(int(i), ()))
                               for i in ids], np.int64)

    # -- the PS server's hook ----------------------------------------------
    def dispatch(self, header: dict, bufs):
        """The server's side of the ``graph`` op (``graph_op`` names the
        query)."""
        sub = header.get("graph_op")
        if sub == "sample_neighbors":
            nbrs, counts = self.sample_neighbors(
                bufs[0], header["sample_size"], header.get("replace",
                                                           False))
            return {"ok": True}, [nbrs, counts]
        if sub == "node_feat":
            return {"ok": True}, [self.get_node_feat(bufs[0])]
        if sub == "degree":
            return {"ok": True}, [self.degree(bufs[0])]
        if sub == "random_nodes":
            return {"ok": True}, [self.random_sample_nodes(header["n"])]
        return {"ok": False, "error": f"unknown graph_op {sub!r}"}, []


class RemoteGraphTable:
    """:class:`GraphTable`'s queries over a ``PsClient``: node ids go to
    server ``id % n``, each shard's reply put back in request order."""

    def __init__(self, client, table: str):
        self.client = client
        self.table = table

    def _fanout(self, ids, header, nbuf_shapes):
        ids = np.asarray(ids, np.int64).reshape(-1)
        owner = ids % self.client.n
        results = [None] * self.client.n

        def one(s):
            mask = owner == s
            if not mask.any():
                return
            _, bufs = self.client._conns[s].rpc(
                dict(header, op="graph", table=self.table), [ids[mask]])
            results[s] = (mask, bufs)

        list(self.client._pool.map(one, range(self.client.n)))
        return ids, results

    def sample_neighbors(self, ids, sample_size: int, replace=False):
        ids, results = self._fanout(
            ids, {"graph_op": "sample_neighbors",
                  "sample_size": sample_size, "replace": replace}, 2)
        nbrs = np.full((ids.size, sample_size), -1, np.int64)
        counts = np.zeros((ids.size,), np.int64)
        for res in results:
            if res is not None:
                mask, bufs = res
                nbrs[mask] = bufs[0]
                counts[mask] = bufs[1]
        return nbrs, counts

    def get_node_feat(self, ids):
        ids, results = self._fanout(ids, {"graph_op": "node_feat"}, 1)
        dim = next(b[0].shape[1] for _, b in
                   (r for r in results if r is not None))
        out = np.zeros((ids.size, dim), np.float32)
        for res in results:
            if res is not None:
                mask, bufs = res
                out[mask] = bufs[0]
        return out

    def degree(self, ids):
        ids, results = self._fanout(ids, {"graph_op": "degree"}, 1)
        out = np.zeros((ids.size,), np.int64)
        for res in results:
            if res is not None:
                mask, bufs = res
                out[mask] = bufs[0]
        return out
