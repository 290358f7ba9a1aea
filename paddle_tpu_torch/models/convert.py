"""Carry the reference model's parameters and optimizer state into the
port.

The JAX package keeps GPT's and BERT's parameters as stacked arrays named
by their ``_PARAM_ORDER``; the port keeps the same names and shapes, so the
conversion is a checked copy.  Take the arrays from a reference model as
``{n: np.asarray(model._parameters[n]._data) for n in _PARAM_ORDER}``, and
the optimizer state from a reference ``TrainStep`` as
``{n: {k: np.asarray(a) for k, a in st.items()} for n, st in
step._opt_states.items()}``.  The ``nn.Module`` layers (Linear, LayerNorm,
the transformer encoder) keep the reference's dotted parameter names:
take their arrays as ``{n: np.asarray(p._data) for n, p in
ref.named_parameters()}`` and load them with :func:`load_named_params`;
their buffers (BatchNorm's ``_mean`` and ``_variance``) likewise from
``ref.named_buffers()`` with :func:`load_named_buffers`.  An eager
optimizer's ``state_dict()`` comes across with :func:`state_dict_from_jax`.

Under tensor parallelism a rank holds shards (``parallel/tp.py``):
:func:`load_named_params` and ``GPT.load_jax_params`` take a sharded
parameter's slice of the full array.  :func:`shard_params` and
:func:`shard_opt_states` cut the reference's full parameters and
optimizer state into one ``mp`` rank's shards (GPT's ``qkv`` head-aligned,
``gpt.MP_SPLITS``; BERT's with ``splits=BERT_MP_SPLITS``, the same
head-aligned cut and ``mlm_bias`` by vocabulary range), and
:func:`full_params` / :func:`full_opt_states` put the ranks' shards back
into the reference's layout.  Under the pipeline
each takes ``pp`` and ``stage`` too: a stage holds its L/pp layers of the
stacked parameters (GPT's twelve ``(L, ...)`` ones, ``gpt.STAGE_SPLIT``)
before its mp cut, and the full layout concatenates the stages.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.models.bert import MP_SPLITS as BERT_MP_SPLITS
from paddle_tpu_torch.models.gpt import _PARAM_ORDER, MP_SPLITS, STAGE_SPLIT
from paddle_tpu_torch.parallel.pipeline import stage_part

__all__ = ["params_from_jax", "opt_states_from_jax", "state_dict_from_jax",
           "load_named_params", "load_named_buffers", "shard_params",
           "shard_opt_states", "full_params", "full_opt_states",
           "BERT_MP_SPLITS", "ps_tables_from_jax", "load_embedding_table"]

# each in-tree optimizer's state keys: Adam and AdamW; Momentum and
# LarsMomentum; Adamax; Adagrad; Adadelta; RMSProp, centred and not; Lamb's
# are Adam's
_STATE_KEYS = (("moment1", "moment2", "beta1_pow", "beta2_pow"),
               ("velocity",), ("moment", "inf_norm", "beta1_pow"),
               ("moment",), ("avg_squared_grad", "avg_squared_update"),
               ("mean_square", "momentum"),
               ("mean_square", "momentum", "mean_grad"))


def _to_torch(a) -> torch.Tensor:
    """A CPU tensor copy of an array, bf16 (``ml_dtypes``) included."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_params: dict, order=_PARAM_ORDER) -> dict:
    """{name: np.ndarray} keyed by the model's ``order`` (GPT's
    ``_PARAM_ORDER`` by default, or BERT's) -> {name: torch.Tensor} (CPU,
    same dtype; copies, so the caller's arrays stay untouched)."""
    missing = [n for n in order if n not in np_params]
    extra = [n for n in np_params if n not in order]
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {missing}, unexpected "
                         f"{extra}")
    return {n: torch.from_numpy(np.array(np_params[n], copy=True))
            for n in order}


def _load_named(kind, tensors: dict, np_named: dict):
    missing = sorted(set(tensors) - set(np_named))
    extra = sorted(set(np_named) - set(tensors))
    if missing or extra:
        raise ValueError(f"load_named_{kind}: missing {missing}, unexpected "
                         f"{extra}")
    with torch.no_grad():
        for name, p in tensors.items():
            t = torch.from_numpy(np.array(np_named[name], copy=True))
            split = getattr(p, "mp_split", None)
            if split is not None:
                t = split[0].take(t, *split[1:])
            if p.shape != t.shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} does not "
                                 f"match {tuple(p.shape)}")
            p.copy_(t)


def load_named_params(module: torch.nn.Module, np_named: dict):
    """Copy {dotted name: np.ndarray}, keyed as the reference layer's
    ``named_parameters()``, into the port module's parameters of the same
    names, in place.  Raises unless the names and shapes match exactly.
    Returns the module."""
    _load_named("params", dict(module.named_parameters()), np_named)
    return module


def load_named_buffers(module: torch.nn.Module, np_named: dict):
    """Copy {dotted name: np.ndarray}, keyed as the reference layer's
    ``named_buffers()`` (``bn1._mean``, ...), into the port module's
    buffers of the same names, in place, with the same exact check of
    names and shapes.  Returns the module."""
    _load_named("buffers", dict(module.named_buffers()), np_named)
    return module


def opt_states_from_jax(states: dict) -> dict:
    """{name: state as numpy} (the reference TrainStep's ``_opt_states``,
    keyed as one of its optimizers' ``init_state``) -> the same structure
    as CPU tensors of the same dtypes, for ``TrainStep.set_opt_states``:
    a run continues from the reference's state."""
    out = {}
    for name, st in states.items():
        if not any(set(st) == set(keys) for keys in _STATE_KEYS):
            raise ValueError(f"opt_states_from_jax: {name} has keys "
                             f"{sorted(st)}, expected one of "
                             f"{[list(k) for k in _STATE_KEYS]}")
        out[name] = {k: _to_torch(a) for k, a in st.items()}
    return out


def state_dict_from_jax(state_dict: dict) -> dict:
    """A reference optimizer's eager ``state_dict()`` with each tensor
    taken as numpy (``{k: v.numpy()}``; ``LR_Scheduler`` and
    ``@global_step`` as they are) -> the port's, for
    ``Optimizer.set_state_dict``: arrays become CPU tensors of the same
    dtype."""
    return {k: _to_torch(v) if isinstance(v, np.ndarray) else v
            for k, v in state_dict.items()}


def _cut(t: torch.Tensor, name, splits, mp, rank, pp, stage):
    """The part of a whole tensor of parameter ``name`` that mp rank
    ``rank`` of stage ``stage`` holds: its stage's layers, then its mp
    shard."""
    if pp > 1 and name in STAGE_SPLIT:
        t = stage_part(t, pp, stage)
    return splits[name].take(t, mp, rank) if name in splits else t


def _join(parts: list, name, splits, mp, pp):
    """The whole tensor of parameter ``name`` from its parts, stage-major
    (pp x mp of them): each stage's mp shards assembled, the stages
    concatenated."""
    per_stage = [splits[name].assemble(parts[s * mp:(s + 1) * mp])
                 if name in splits else parts[s * mp] for s in range(pp)]
    return torch.cat(per_stage, 0) if pp > 1 and name in STAGE_SPLIT \
        else per_stage[0]


def shard_params(params: dict, mp: int, rank: int, splits=None, pp: int = 1,
                 stage: int = 0) -> dict:
    """{name: full np.ndarray} -> {name: CPU tensor}, ``mp`` rank
    ``rank``'s shards of pipeline stage ``stage`` of ``pp``: a stacked
    name (``gpt.STAGE_SPLIT``) cut to its stage's layers, a name in
    ``splits`` ({name: tp.Split}, GPT's ``MP_SPLITS`` by default) cut as
    it says, the rest whole copies."""
    splits = MP_SPLITS if splits is None else splits
    return {n: _cut(_to_torch(a), n, splits, mp, rank, pp, stage)
            for n, a in params.items()}


def shard_opt_states(states: dict, params: dict, mp: int, rank: int,
                     splits=None, pp: int = 1, stage: int = 0) -> dict:
    """The reference's optimizer state {name: {slot: np.ndarray}} ->
    ``mp`` rank ``rank``'s of stage ``stage``, as ``opt_states_from_jax``
    gives it: each slot shaped as its full parameter (``params`` {name:
    full array}) cut as the parameter is, the scalars whole."""
    splits = MP_SPLITS if splits is None else splits
    return {n: {k: _cut(v, n, splits, mp, rank, pp, stage)
                if v.shape == np.shape(params[n]) else v
                for k, v in st.items()}
            for n, st in opt_states_from_jax(states).items()}


def full_params(shards, splits=None, pp: int = 1) -> dict:
    """The ranks' shard dicts, stage-major (``pp`` stages of the mp
    ranks in order; one stage by default) -> {name: the full tensor}:
    split names assembled, stacked names concatenated over the stages,
    the rest taken from rank 0."""
    splits = MP_SPLITS if splits is None else splits
    mp = len(shards) // pp
    return {n: _join([s[n] for s in shards], n, splits, mp, pp)
            for n in shards[0]}


def full_opt_states(shards, params: dict, splits=None, pp: int = 1) -> dict:
    """The ranks' optimizer states, stage-major as :func:`full_params`
    takes them -> the full one: a slot shaped as its parameter's shard
    assembled, scalars from rank 0.  ``params`` is one rank's {name:
    shard}, to tell the slots."""
    splits = MP_SPLITS if splits is None else splits
    mp = len(shards) // pp
    return {n: {k: _join([s[n][k] for s in shards], n, splits, mp, pp)
                if v.shape == params[n].shape else v
                for k, v in st.items()}
            for n, st in shards[0].items()}


def ps_tables_from_jax(src):
    """The parameter server's tables of the reference as numpy: a host
    table (``HostEmbeddingTable``, ``HashEmbeddingTable``) -> copies of its
    ``state_dict()``, for the port's ``set_state_dict``; a
    ``ShardedEmbedding`` or ``MeshShardedEmbedding`` -> a copy of its whole
    (V, E) table, for :func:`load_embedding_table`."""
    if hasattr(src, "push") and hasattr(src, "state_dict"):
        return {k: np.array(v, copy=True) if isinstance(v, np.ndarray)
                else v for k, v in src.state_dict().items()}
    return np.array(src.weight._data, copy=True)


def load_embedding_table(layer, table) -> None:
    """Copy a whole (V, E) table (numpy) into a port ``ShardedEmbedding``
    or ``MeshShardedEmbedding``: this rank's row block where the layer
    holds one (its ``mp`` shard; its range of the padded table)."""
    t = torch.from_numpy(np.array(table, np.float32, copy=True))
    w = layer.weight
    split = getattr(w, "mp_split", None)
    if split is not None:
        t = split[0].take(t, *split[1:])
    elif t.shape[0] != w.shape[0]:
        mesh, axis = getattr(layer, "mesh", None), layer.mesh_axis
        lo = (mesh.axis_index(axis) if mesh is not None and
              mesh.shape.get(axis, 1) > 1 else 0) * w.shape[0]
        t = t[lo:lo + w.shape[0]]
    if t.shape != w.shape:
        raise ValueError(f"table {tuple(t.shape)} does not match "
                         f"{tuple(w.shape)}")
    with torch.no_grad():
        w.copy_(t)
