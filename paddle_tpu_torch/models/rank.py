"""Recommendation models: Wide&Deep, DeepFM and the host-table Wide&Deep
(port of paddle_tpu/models/rank.py).

``WideDeep`` and ``DeepFM`` look their sparse features up in
``distributed.ps.ShardedEmbedding`` tables (both drawn from seed 0, as in
the reference; each rank holds a row block at ``mp`` > 1) and train under
``jit.TrainStep`` or ``ShardedTrainStep`` with dense gradients.
``WideDeepHost`` takes rows pulled from a host table
(``distributed.ps.PSTrainStep``), the deep embedding and the wide slot
from one (B, F, E + 1) pull.  Their ``Linear`` weights are drawn as the
port's ``Linear`` draws them; ``models.load_named_params`` copies the
reference's in by name (``deep.0.weight``, ...).  Every model lands on
the card unless ``device`` asks for the CPU.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed.ps import ShardedEmbedding
from paddle_tpu_torch.nn import Layer, Linear, ReLU, Sequential

__all__ = ["WideDeep", "DeepFM", "WideDeepHost"]


def _tower(in_dim: int, hidden, device) -> Sequential:
    """Linear + ReLU for each hidden width, then Linear to one logit."""
    dims = [in_dim, *hidden]
    layers = []
    for i in range(len(hidden)):
        layers += [Linear(dims[i], dims[i + 1], device=device), ReLU()]
    layers += [Linear(dims[-1], 1, device=device)]
    return Sequential(*layers)


def _deep_in(emb: torch.Tensor, dense_x) -> torch.Tensor:
    dense_x = torch.as_tensor(dense_x, device=emb.device)
    return torch.cat([emb.reshape(emb.shape[0], -1), dense_x], dim=1)


class WideDeep(Layer):
    """Wide (a linear term over the sparse ids) + Deep (an MLP over their
    embeddings and the dense features)."""

    def __init__(self, num_features: int = 100_000, embedding_dim: int = 16,
                 num_fields: int = 26, dense_dim: int = 13,
                 hidden=(256, 128, 64), device=None, mesh=None):
        super().__init__()
        self.num_fields = num_fields
        self.embedding = ShardedEmbedding(num_features, embedding_dim,
                                          device=device, mesh=mesh)
        self.wide = ShardedEmbedding(num_features, 1, device=device,
                                     mesh=mesh)
        self.deep = _tower(num_fields * embedding_dim + dense_dim, hidden,
                           device)

    def forward(self, sparse_ids, dense_x):
        """sparse_ids (B, F) int, dense_x (B, D) float -> logits (B, 1)."""
        emb = self.embedding(sparse_ids)                   # (B, F, E)
        deep_out = self.deep(_deep_in(emb, dense_x))       # (B, 1)
        return deep_out + self.wide(sparse_ids).sum(dim=1)


class DeepFM(Layer):
    """A factorization machine and a deep tower sharing one table."""

    def __init__(self, num_features: int = 100_000, embedding_dim: int = 16,
                 num_fields: int = 26, dense_dim: int = 13,
                 hidden=(256, 128), device=None, mesh=None):
        super().__init__()
        self.num_fields = num_fields
        self.embedding = ShardedEmbedding(num_features, embedding_dim,
                                          device=device, mesh=mesh)
        self.first_order = ShardedEmbedding(num_features, 1, device=device,
                                            mesh=mesh)
        self.deep = _tower(num_fields * embedding_dim + dense_dim, hidden,
                           device)

    def forward(self, sparse_ids, dense_x):
        emb = self.embedding(sparse_ids)                   # (B, F, E)
        # second order: 0.5 ((sum v)^2 - sum v^2)
        sum_sq = torch.square(emb.sum(dim=1))
        sq_sum = torch.square(emb).sum(dim=1)
        fm2 = 0.5 * (sum_sq - sq_sum).sum(dim=1, keepdim=True)
        fm1 = self.first_order(sparse_ids).sum(dim=1)
        return fm1 + fm2 + self.deep(_deep_in(emb, dense_x))


class WideDeepHost(Layer):
    """Wide&Deep over rows pulled from a host table: ``forward(rows,
    dense_x)`` with ``rows`` (B, F, E + 1), the deep embedding in the
    first E dims and the wide slot in the last, so one pull and one push
    serve both towers.  Train it with ``distributed.ps.PSTrainStep``."""

    def __init__(self, embedding_dim: int = 64, num_fields: int = 26,
                 dense_dim: int = 13, hidden=(1024, 512, 256), device=None):
        super().__init__()
        self.num_fields = num_fields
        self.embedding_dim = embedding_dim
        self.deep = _tower(num_fields * embedding_dim + dense_dim, hidden,
                           device)

    def forward(self, rows, dense_x):
        """rows (B, F, E + 1) pulled float rows, dense_x (B, D)."""
        emb = rows[:, :, :self.embedding_dim]
        wide = rows[:, :, self.embedding_dim:]
        return self.deep(_deep_in(emb, dense_x)) + wide.sum(dim=1)
