"""Tensor-model-parallel layers (port of paddle_tpu/distributed/
tp_layers.py :1-97).

The reference's layers are dense layers whose parameters carry an ``mp``
``DistAttr``; GSPMD partitions them under its sharded step and an eager
single-chip call is the plain layer.  The port writes the Megatron
program by hand (``parallel/tp.py``): built, or given a mesh through
:meth:`apply_mesh` (``ShardedTrainStep`` does), where the mesh's ``mp``
axis has size m > 1, each layer holds only its rank's slice of a split
parameter:

- :class:`ColumnParallelLinear`: W[:, the rank's columns] and that slice
  of the bias; the input enters through ``tp.copy_to`` (identity forward,
  the sum over ``mp`` in the backward), and with ``gather_output`` the
  output is all-gathered at the end;
- :class:`RowParallelLinear`: W[the rank's rows, :]; with
  ``input_is_parallel=False`` it takes its slice of x (``tp.scatter``);
  the partial products are summed over ``mp`` (identity backward) and the
  replicated bias is added after the sum (reference ``:75-76``);
- :class:`VocabParallelEmbedding`: the rank's vocabulary range; a masked
  local lookup (ids outside the range read 0 here) summed over ``mp``;
  ``padding_idx`` reads 0 and passes no gradient, as in ``Embedding``.

With no mesh, or an ``mp`` axis of size 1, each is its plain layer.  The
layers draw their full initial weights as the plain layer does and keep
their slice; ``models.load_named_params`` takes the slice of a full array
from the reference, and ``parallel.tp.full_parameters`` (or
``ShardedTrainStep.gather_params``) gives the full arrays back.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import Embedding, Linear
from paddle_tpu_torch.parallel import tp
from paddle_tpu_torch.parallel.mesh import DistAttr, constrain, current_mesh

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "mark_sharding"]


def mark_sharding(x, *spec):
    """The reference's sharding constraint (``shard_tensor``): each rank's
    program is already manual, so x comes back as it is, its spec checked
    against its rank (``parallel.mesh.constrain``)."""
    return constrain(x, *spec)


class _MPLayer:
    """The mesh bookkeeping of a layer split over ``mp_axis``."""

    _splits: dict = {}

    def _init_mp(self, mp_axis, mesh):
        self.mp_axis = mp_axis
        self._group = None
        mesh = mesh if mesh is not None else current_mesh()
        if mesh is not None and mesh.shape.get(mp_axis, 1) > 1:
            self.apply_mesh(mesh)

    def apply_mesh(self, mesh):
        """Hold this rank's slices for ``mesh``'s ``mp_axis`` (once)."""
        n = mesh.shape.get(self.mp_axis, 1)
        if n == 1:
            return self
        if self._group is not None:
            if self._group.size != n:
                raise ValueError(f"{type(self).__name__} holds "
                                 f"{self._group.size} shards, the mesh has "
                                 f"{self.mp_axis}={n}")
            return self
        idx = mesh.axis_index(self.mp_axis)
        for name, split in self._splits.items():
            p = getattr(self, name)
            if p is not None:
                tp.shard_parameter(p, split, n, idx)
        self._group = mesh.axis_group(self.mp_axis)
        return self


class ColumnParallelLinear(_MPLayer, Linear):
    """Y = X W with W split by columns over ``mp``; the output stays split
    unless ``gather_output``."""

    _splits = {"weight": tp.Split(1), "bias": tp.Split(0)}

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, gather_output: bool = True, name=None,
                 mp_axis: str = "mp", device=None, mesh=None):
        Linear.__init__(self, in_features, out_features,
                        weight_attr=weight_attr, bias_attr=bias_attr,
                        name=name, device=device)
        self.gather_output = gather_output
        self.weight.dist_attr = DistAttr((None, mp_axis))
        if self.bias is not None:
            self.bias.dist_attr = DistAttr((mp_axis,))
        self._init_mp(mp_axis, mesh)

    def forward(self, x):
        if self._group is None:
            return Linear.forward(self, x)
        y = F.linear(tp.copy_to(x, self._group), self.weight, self.bias)
        return tp.gather(y, self._group, -1) if self.gather_output else y


class RowParallelLinear(_MPLayer, Linear):
    """Y = X W with W split by rows over ``mp``; X arrives split on its
    last dim when ``input_is_parallel`` (a non-gathered column layer's
    output), else each rank takes its slice."""

    _splits = {"weight": tp.Split(0)}

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, input_is_parallel: bool = False, name=None,
                 mp_axis: str = "mp", device=None, mesh=None):
        Linear.__init__(self, in_features, out_features,
                        weight_attr=weight_attr, bias_attr=bias_attr,
                        name=name, device=device)
        self.input_is_parallel = input_is_parallel
        self.weight.dist_attr = DistAttr((mp_axis, None))
        self._init_mp(mp_axis, mesh)

    def forward(self, x):
        if self._group is None:
            return Linear.forward(self, x)
        if not self.input_is_parallel:
            x = tp.scatter(x, self._group, -1)
        y = tp.reduce(F.linear(x, self.weight), self._group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(_MPLayer, Embedding):
    """An embedding whose vocabulary is split over ``mp``: each rank owns a
    contiguous range of ids."""

    _splits = {"weight": tp.Split(0)}

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None,
                 mp_axis: str = "mp", device=None, mesh=None):
        Embedding.__init__(self, num_embeddings, embedding_dim,
                           padding_idx=padding_idx, sparse=sparse,
                           weight_attr=weight_attr, name=name, device=device)
        self.weight.dist_attr = DistAttr((mp_axis, None))
        self._init_mp(mp_axis, mesh)

    def forward(self, x):
        if self._group is None:
            return Embedding.forward(self, x)
        return vocab_lookup(self.weight, x, self._group, self._padding_idx)


def vocab_lookup(table: torch.Tensor, ids, group, padding_idx=None):
    """The rows of the full table of ``group``'s vocabulary-split shards
    (``table`` this rank's, rank r owning ids [r V/m, (r + 1) V/m)): a
    masked local lookup summed over the group in rank order."""
    ids = ids.long()
    vr = table.shape[0]
    local = ids - group.rank * vr
    keep = (local >= 0) & (local < vr)
    if padding_idx is not None:
        keep = keep & (ids != padding_idx)
    # torch's embedding: its CPU backward sums each row in index order
    rows = torch.nn.functional.embedding(local.clamp(0, vr - 1), table)
    rows = rows * keep[..., None].to(rows.dtype)
    return tp.reduce(rows, group)
