"""The parameter server's graph table of the port
(paddle_tpu_torch/distributed/ps/graph.py) against the reference's, on the
CPU: a table built and queried the same way draws the same samples, index
for index, and gives the same features, degrees and random nodes; served
by PsServers (one, and two sharded by id % 2) and read through
RemoteGraphTable it answers as the local table and as the reference's
remote one; a GraphSAGE-style model on two 8-node cliques trains to the
reference's losses.

Tolerances: samples, counts, features, degrees and nodes bitwise; the
GraphSAGE losses within 1e-5 of the largest (f32 in two libraries).
Graphs of 16 to 300 nodes."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed.ps import graph as jgraph
from paddle_tpu.distributed.ps import service as jsvc
import paddle_tpu_torch as tpt
from paddle_tpu_torch.distributed.ps import graph
from paddle_tpu_torch.distributed.ps import service as svc
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam

REL = 1e-5


def _random_graph(mod, n=300, m=1500, dim=6, seed=0, shard=None):
    """A graph of n nodes and m bidirectional edges drawn from ``seed``,
    features for every node; ``shard`` = (s, k) keeps the nodes of server
    s of k (id % k == s) with their whole adjacency, in the same order."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    feats = rng.standard_normal((n, dim)).astype(np.float32)
    g = mod.GraphTable(embedding_dim=dim, seed=3)
    a, b = np.concatenate([src, dst]), np.concatenate([dst, src])
    ids = np.arange(n)
    if shard is not None:
        keep = a % shard[1] == shard[0]
        a, b = a[keep], b[keep]
        ids = ids[ids % shard[1] == shard[0]]
    g.add_edges(a, b)
    g.set_node_feat(ids, feats[ids])
    return g


def _queries(g):
    out = []
    rng = np.random.default_rng(7)
    for k, replace in ((5, False), (3, True), (40, False)):
        ids = rng.integers(0, 310, 64)         # 300-309 have no edge
        out += list(g.sample_neighbors(ids, k, replace=replace))
    out.append(g.get_node_feat(rng.integers(0, 310, 50)))
    out.append(g.degree(np.arange(310)))
    out.append(g.random_sample_nodes(20))
    out.append(g.random_sample_nodes(1000))
    out += list(g.sample_neighbors(np.arange(300), 4))
    return out


def test_samples_features_degrees_and_nodes_bitwise():
    got = _queries(_random_graph(graph))
    want = _queries(_random_graph(jgraph))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_star_graph_edge_cases():
    """Padding with -1 past a node's degree, sampling with replacement from
    one neighbour, an isolated node, a node without features."""
    for mod in (graph, jgraph):
        g = mod.GraphTable(embedding_dim=4)
        g.add_edges([0] * 5, [1, 2, 3, 4, 5], bidirectional=True)
        g.set_node_feat(np.arange(9), np.eye(9, 4, dtype=np.float32))
        nbrs, counts = g.sample_neighbors(np.array([0, 1, 9]), 3)
        assert counts.tolist() == [3, 1, 0]
        assert nbrs[1].tolist() == [0, -1, -1] and (nbrs[2] == -1).all()
        nbrs, counts = g.sample_neighbors(np.array([1]), 4, replace=True)
        assert counts.tolist() == [4] and (nbrs == 0).all()
        assert not g.get_node_feat(np.array([9])).any()
        assert g.dispatch({"graph_op": "nope"}, [])[0]["ok"] is False


def _serve_graphs(smod, gmod, shards):
    if shards == 1:
        tables = [_random_graph(gmod)]
    else:
        tables = [_random_graph(gmod, shard=(s, shards))
                  for s in range(shards)]
    return [smod.PsServer({"g": t}, port=0).start() for t in tables]


def _remote_queries(smod, gmod, shards):
    srvs = _serve_graphs(smod, gmod, shards)
    try:
        c = smod.PsClient([f"127.0.0.1:{s.port}" for s in srvs])
        rg = gmod.RemoteGraphTable(c, "g")
        rng = np.random.default_rng(9)
        out = []
        for k in (5, 12):
            out += list(rg.sample_neighbors(rng.integers(0, 310, 40), k))
        out.append(rg.get_node_feat(rng.integers(0, 300, 30)))
        out.append(rg.degree(np.arange(310)))
        c.bye()
    finally:
        for s in srvs:
            s.shutdown()
    return out


@pytest.mark.parametrize("shards", [1, 2])
def test_remote_graph_equals_local_and_the_reference(shards):
    """Served by one PsServer the remote table's answers are the local
    table's; sharded id % 2 over two, the reference's remote answers;
    either way features and degrees are the whole graph's."""
    got = _remote_queries(svc, graph, shards)
    want = _remote_queries(jsvc, jgraph, shards)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    local = _random_graph(graph)
    rng = np.random.default_rng(9)
    ids = [rng.integers(0, 310, 40) for _ in range(2)]
    feat_ids = rng.integers(0, 300, 30)
    if shards == 1:
        want_local = []
        for k, i in zip((5, 12), ids):
            want_local += list(local.sample_neighbors(i, k))
        for x, y in zip(got[:4], want_local):
            assert np.array_equal(x, y)
    assert np.array_equal(got[4], local.get_node_feat(feat_ids))
    assert np.array_equal(got[5], local.degree(np.arange(310)))


def _cliques(mod):
    rng = np.random.default_rng(0)
    g = mod.GraphTable()
    for base in (0, 8):
        for i in range(8):
            for j in range(i + 1, 8):
                g.add_edges([base + i], [base + j], bidirectional=True)
    feats = rng.standard_normal((16, 6)).astype(np.float32)
    feats[:8] += 1.5
    feats[8:] -= 1.5
    g.set_node_feat(np.arange(16), feats)
    return g, feats


def _sample(g):
    nbrs, counts = g.sample_neighbors(np.arange(16), 4)
    flat = nbrs.reshape(-1)
    valid = flat >= 0
    nbr_feat = g.get_node_feat(np.where(valid, flat, 0))
    nbr_feat[~valid] = 0.0
    return nbr_feat, np.maximum(counts, 1).astype(np.float32)[:, None]


def test_graphsage_two_cliques_trains_as_the_reference():
    """25 Adam steps of a linear classifier over each node's features and
    its sampled neighbours' mean (segment_sum over the samples): the
    port's losses within 1e-5 of the largest of the reference's, falling
    below a fifth of the first."""
    labels = np.array([0] * 8 + [1] * 8, np.int64)
    seg = np.repeat(np.arange(16), 4)
    paddle.seed(0)
    jlin = jnn.Linear(12, 2)
    init = {n: np.asarray(p._data) for n, p in jlin.named_parameters()}
    jg, feats = _cliques(jgraph)
    jo = paddle.optimizer.Adam(learning_rate=0.1,
                               parameters=jlin.parameters())
    want = []
    for _ in range(25):
        nbr_feat, denom = _sample(jg)
        agg = paddle.segment_sum(paddle.to_tensor(nbr_feat),
                                 paddle.to_tensor(seg), num_segments=16)
        h = paddle.concat([paddle.to_tensor(feats),
                           agg / paddle.to_tensor(denom)], axis=1)
        loss = JF.cross_entropy(jlin(h), paddle.to_tensor(labels))
        loss.backward()
        jo.step()
        jo.clear_grad()
        want.append(float(loss))

    lin = load_named_params(Linear(12, 2, device="cpu"), init)
    g, _ = _cliques(graph)
    opt = Adam(learning_rate=0.1, parameters=lin.parameters())
    got = []
    for _ in range(25):
        nbr_feat, denom = _sample(g)
        agg = tpt.segment_sum(torch.from_numpy(nbr_feat),
                              torch.from_numpy(seg), num_segments=16)
        h = torch.cat([torch.from_numpy(feats),
                       agg / torch.from_numpy(denom)], 1)
        loss = F.cross_entropy(lin(h), torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        got.append(float(loss.detach()))
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    assert got[-1] < got[0] * 0.2
