"""BERT / ERNIE — the encoder flagship (port of paddle_tpu/models/bert.py).

MLM and NSP logits through :meth:`Bert.forward` and the pretraining loss
through :func:`bert_pretrain_loss`, both on autograd's tape; serving
callers wrap their calls in ``torch.inference_mode()``.

What is the same as the reference: the configuration and presets, the 26
parameters of ``_PARAM_ORDER`` with the same names, shapes and numpy
draws (``np.random.default_rng(seed)`` in the same order), token, position
and token-type embeddings with their layer norm, post-LN layers with
eps 1e-12 and tanh-GELU, the pooler, the MLM head tied to ``wte`` plus
``mlm_bias``, the NSP head, and the loss conventions (MLM labels -100 are
ignored), and ``remat`` (the default): each layer, the padding bias
passed in, is one recompute region under autograd (``jit/recompute.py``,
the reference's ``jax.checkpoint(layer)``, ``:219``).  What differs, as in
the GPT port: a Python loop over layers stands in for ``lax.scan``.

Tensor parallelism (the reference's ``DistAttr``s, ``:94-120``, and its
``_mark`` constraints, ``:143-145``).  Built under an active mesh whose
``mp`` axis has size m > 1, or given one by :meth:`Bert.apply_mesh`
(``ShardedTrainStep`` does), a Bert holds this rank's shards, cut as
GPT's are (``MP_SPLITS``): ``wte`` and ``mlm_bias`` by vocabulary range,
``qkv_w`` / ``qkv_b`` head-aligned (rank r holds heads [r nh/m, (r + 1)
nh/m) of q, of k and of v; ``models/convert.py`` permutes the reference's
contiguous layout in and out), ``fc_w`` / ``fc_b`` by output columns,
``prj_w`` / ``out_w`` by input rows, the rest whole.  The layers run on
the rank's heads and FFN columns: ``tp.copy_to`` before the column-split
products, ``tp.reduce`` (the sum over ``mp`` in rank order) after the
row-split ones, before their replicated bias; the embedding is the
vocabulary-parallel lookup and the tied MLM head gives the rank's
vocabulary columns, ``h @ wte_shard.T + mlm_bias_shard``.
:meth:`Bert.forward` all-gathers the (B, S, V) MLM logits;
:func:`bert_pretrain_loss` takes the MLM term through
``parallel.tp.vocab_parallel_ce`` (no rank holds the (B, S, V) logits),
with the reference's labels: -100 ignored, the mean over the labelled
positions (at least one).  ``num_heads``, the vocabulary and the FFN
width must divide by m.  The reference strips ``sp`` from its
constraints and its forward has no pipeline, so on an ``sp`` or ``pp``
axis a Bert is a replica on each rank.  ``remat=True`` at mp > 1 replays
the collectives in the backward: it runs on the CPU and one rank a
process, and raises on ``LoopbackWorld`` ranks on the card.

Attention dispatches as the reference's ``_bert_forward`` does, by rule
and device and never by catching an error (the reference's ``try/except``
around its rule is not copied): a padding ``attention_mask`` (B, S),
1 = real token, becomes a (B, 1, 1, S) f32 bias of 0 / -1e30 that takes no
gradient, so the dbias kernel never runs; shapes the flash kernel serves
(``flash_attention.supported``, head dim 64 or 128, f32 or bf16, S a
multiple of 128 when masked) take it, the CUDA kernel on a CUDA tensor and its plain
version on a CPU tensor, and the others take the dense ``_xla_attention``.
The reference's TPU crossover (non-causal S < 1024 to XLA) is a TPU timing
and is not part of the rule.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import _op_scope, amp_cast_for_op
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.parameter import Parameter
from paddle_tpu_torch.jit.recompute import recompute
from paddle_tpu_torch.nn.functional.attention import _xla_attention
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.ops.cuda import flash_attention as _fa
from paddle_tpu_torch.parallel import tp
from paddle_tpu_torch.parallel.mesh import (DistAttr, current_mesh,
                                            in_loopback,
                                            require_no_model_parallel)

__all__ = ["BertConfig", "Bert", "bert_base", "bert_tiny",
           "bert_pretrain_loss", "Ernie", "ErnieConfig"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_size: Optional[int] = None,
                 max_seq_len=512, type_vocab_size=2,
                 initializer_range=0.02, remat: bool = True, seed: int = 0,
                 use_flash_attention: bool = True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        # recompute each layer in the backward (jit/recompute.py)
        self.remat = remat
        self.seed = seed
        self.use_flash_attention = use_flash_attention

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


ErnieConfig = BertConfig  # ERNIE-1.0 = BERT architecture + corpus recipe


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_seq_len", 128)
    return BertConfig(**kw)


_PARAM_ORDER = ("wte", "wpe", "wtt", "emb_ln_w", "emb_ln_b",
                "ln1_w", "ln1_b", "qkv_w", "qkv_b", "prj_w", "prj_b",
                "ln2_w", "ln2_b", "fc_w", "fc_b", "out_w", "out_b",
                "pool_w", "pool_b", "mlm_w", "mlm_b", "mlm_ln_w",
                "mlm_ln_b", "mlm_bias", "nsp_w", "nsp_b")
_LAYER_PARAMS = _PARAM_ORDER[5:17]


def init_params(c: BertConfig) -> dict:
    """The reference's initial parameters as numpy arrays: the same
    ``default_rng(seed)`` draws in the same order (bert.py:80-122)."""
    rng = np.random.default_rng(c.seed)
    std = c.initializer_range
    L, H, F_, V = c.num_layers, c.hidden_size, c.ffn_size, c.vocab_size

    def norm(shape, scale=std):
        return rng.standard_normal(shape).astype(np.float32) * scale

    def ones(*shape):
        return np.ones(shape, np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    p = {}
    p["wte"] = norm((V, H))
    p["wpe"] = norm((c.max_seq_len, H))
    p["wtt"] = norm((c.type_vocab_size, H))
    p["emb_ln_w"], p["emb_ln_b"] = ones(H), zeros(H)
    p["ln1_w"], p["ln1_b"] = ones(L, H), zeros(L, H)
    p["qkv_w"], p["qkv_b"] = norm((L, H, 3 * H)), zeros(L, 3 * H)
    p["prj_w"] = norm((L, H, H), std / math.sqrt(2 * L))
    p["prj_b"] = zeros(L, H)
    p["ln2_w"], p["ln2_b"] = ones(L, H), zeros(L, H)
    p["fc_w"], p["fc_b"] = norm((L, H, F_)), zeros(L, F_)
    p["out_w"] = norm((L, F_, H), std / math.sqrt(2 * L))
    p["out_b"] = zeros(L, H)
    p["pool_w"], p["pool_b"] = norm((H, H)), zeros(H)
    p["mlm_w"], p["mlm_b"] = norm((H, H)), zeros(H)
    p["mlm_ln_w"], p["mlm_ln_b"] = ones(H), zeros(H)
    p["mlm_bias"] = zeros(V)
    p["nsp_w"], p["nsp_b"] = norm((H, 2)), zeros(2)
    return {n: p[n] for n in _PARAM_ORDER}


# the reference's annotations (bert.py:94-120)
DIST_ATTRS = {"wte": ("mp", None), "ln1_w": ("pp",), "ln1_b": ("pp",),
              "qkv_w": ("pp", None, "mp"), "qkv_b": ("pp", "mp"),
              "prj_w": ("pp", "mp", None), "prj_b": ("pp",),
              "ln2_w": ("pp",), "ln2_b": ("pp",), "fc_w": ("pp", None, "mp"),
              "fc_b": ("pp", "mp"), "out_w": ("pp", "mp", None),
              "out_b": ("pp",), "mlm_bias": ("mp",)}
# how the port cuts each mp-split parameter: GPT's cuts (qkv head-aligned,
# the rest contiguously) and the MLM bias by vocabulary range
MP_SPLITS = {"wte": tp.Split(0), "qkv_w": tp.Split(2, 3),
             "qkv_b": tp.Split(1, 3), "fc_w": tp.Split(2),
             "fc_b": tp.Split(1), "prj_w": tp.Split(1), "out_w": tp.Split(1),
             "mlm_bias": tp.Split(0)}


class Bert(Layer):
    def __init__(self, config: BertConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        for name, value in init_params(config).items():
            p = Parameter(torch.from_numpy(value).to(dev), name=f"bert.{name}")
            if name in DIST_ATTRS:
                p.dist_attr = DistAttr(DIST_ATTRS[name])
            self.register_parameter(name, p)
        self._mp_group = None
        mesh = mesh if mesh is not None else current_mesh()
        if mesh is not None and mesh.shape.get("mp", 1) > 1:
            self.apply_mesh(mesh)

    def apply_mesh(self, mesh) -> "Bert":
        """Hold this rank's shards where ``mesh``'s ``mp`` axis has size
        m > 1 (once; a second mesh must have the same m).  ``sp`` and
        ``pp`` leave a replica; ``ep`` raises."""
        require_no_model_parallel(mesh, "Bert")
        c = self.config
        m = mesh.shape.get("mp", 1)
        held = 1 if self._mp_group is None else self._mp_group.size
        if held != 1:
            if m != held:
                raise ValueError(f"Bert holds {held} mp shards; the mesh "
                                 f"has mp={m}")
            return self
        if m > 1:
            for what, size in (("num_heads", c.num_heads),
                               ("vocab_size", c.vocab_size),
                               ("ffn_size", c.ffn_size)):
                if size % m:
                    raise ValueError(f"Bert at mp={m}: {what}={size} does "
                                     f"not divide by {m}")
            idx = mesh.axis_index("mp")
            for name, split in MP_SPLITS.items():
                tp.shard_parameter(getattr(self, name), split, m, idx)
            self._mp_group = mesh.axis_group("mp")
        return self

    def load_jax_params(self, np_params: dict) -> "Bert":
        """Copy the reference model's parameters in (``np.asarray`` of
        each ``model._parameters[n]._data``), keyed by ``_PARAM_ORDER``;
        a sharded Bert takes its shards of them."""
        from paddle_tpu_torch.models.convert import params_from_jax
        with torch.no_grad():
            for name, t in params_from_jax(np_params, _PARAM_ORDER).items():
                p = getattr(self, name)
                split = getattr(p, "mp_split", None)
                if split is not None:
                    t = split[0].take(t, *split[1:])
                if p.shape != t.shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)} does "
                                     f"not match {tuple(p.shape)}")
                p.copy_(t)
        return self

    def _local(self, input_ids, token_type_ids=None, attention_mask=None):
        """This rank's (mlm_logits (B, S, V/m), nsp_logits (B, 2))."""
        dev = self.wte.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        tt = (torch.zeros_like(ids) if token_type_ids is None else
              torch.as_tensor(token_type_ids, device=dev).long())
        mask = (None if attention_mask is None else
                torch.as_tensor(attention_mask, device=dev))
        # one op for amp.auto_cast, as the reference's ``bert_forward``
        cast = amp_cast_for_op("bert_forward", [getattr(self, n) for n in
                                                _PARAM_ORDER] + [mask])
        with _op_scope():
            return _bert_forward(self.config, dict(zip(_PARAM_ORDER, cast)),
                                 ids, tt, cast[-1], group=self._mp_group)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """input_ids (B, S) int, optional token_type_ids (B, S) and
        attention_mask (B, S) (1 = real token) -> (mlm_logits (B, S, V),
        nsp_logits (B, 2)); at mp > 1 the MLM logits all-gathered."""
        mlm, nsp = self._local(input_ids, token_type_ids, attention_mask)
        return tp.gather(mlm, self._mp_group, -1), nsp


def _ln(x, w, b, eps=1e-12):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _flash_ok(cfg: BertConfig, b, s, bias, dtype=None, nh=None) -> bool:
    shape = (b, s, cfg.num_heads if nh is None else nh, cfg.head_dim)
    return cfg.use_flash_attention and _fa.supported(
        shape, shape, bias is None,
        bias_shape=None if bias is None else tuple(bias.shape), dtype=dtype)


def _layer(cfg: BertConfig, x, lp, bias, group=None):
    """One post-LN layer on this rank's heads and FFN columns (all of them
    with no ``mp`` group): the column-split products take x through
    ``tp.copy_to``, the row-split ones sum over ``mp`` before their
    replicated bias."""
    b, s = x.shape[:2]
    nh = cfg.num_heads // (1 if group is None else group.size)
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    qkv = tp.copy_to(x, group) @ lp["qkv_w"] + lp["qkv_b"]
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(nh * hd, dim=-1))
    if _flash_ok(cfg, b, s, bias, q.dtype, nh):
        a = _fa.flash_attention(q, k, v, scale=scale, bias=bias)
    else:
        a = _xla_attention(q, k, v, bias, scale, False)
    # post-LN (original BERT): LN(x + sublayer(x))
    x = _ln(x + tp.reduce(a.reshape(b, s, nh * hd) @ lp["prj_w"], group)
            + lp["prj_b"], lp["ln1_w"], lp["ln1_b"])
    ff = F.gelu(tp.copy_to(x, group) @ lp["fc_w"] + lp["fc_b"],
                approximate="tanh")
    return _ln(x + tp.reduce(ff @ lp["out_w"], group) + lp["out_b"],
               lp["ln2_w"], lp["ln2_b"])


def _bert_forward(cfg: BertConfig, p: dict, ids, tt, mask,
                  features_only: bool = False, group=None):
    """The forward over the parameters ``p`` ({name in _PARAM_ORDER:
    tensor}, this rank's shards under the ``mp`` ``group``) -> (this
    rank's MLM logits (B, S, V/m), NSP logits (B, 2)); with
    ``features_only`` the last layer's hidden states (B, S, H)."""
    S = ids.shape[1]
    if group is not None:
        from paddle_tpu_torch.distributed.tp_layers import vocab_lookup
        if cfg.remat and torch.is_grad_enabled() and in_loopback() and \
                ids.is_cuda:
            # the replay would meet the collectives on autograd's one
            # device thread, where one rank's wait blocks the other's
            raise NotImplementedError(
                "Bert(remat=True) at mp > 1 on LoopbackWorld ranks on the "
                "card: build it with remat=False, or run one rank a process")
        wte_rows = vocab_lookup(p["wte"], ids, group)
    else:
        wte_rows = p["wte"][ids]
    x = wte_rows + p["wpe"][:S][None] + p["wtt"][tt]
    x = _ln(x, p["emb_ln_w"], p["emb_ln_b"])
    # the padding mask as an additive (B, 1, 1, S) f32 bias (reference
    # :162-166); it takes no gradient, so the dbias kernel never runs
    bias = None
    if mask is not None:
        bias = torch.where(mask.bool(), 0.0, -1e30)[:, None, None, :]
    # one unbind per stacked parameter: its backward is one stack
    per_layer = {n: p[n].unbind(0) for n in _LAYER_PARAMS}
    layer = functools.partial(recompute, _layer) if cfg.remat else _layer
    for i in range(cfg.num_layers):
        x = layer(cfg, x, {n: per_layer[n][i] for n in _LAYER_PARAMS}, bias,
                  group)
    if features_only:
        return x
    pooled = torch.tanh(x[:, 0] @ p["pool_w"] + p["pool_b"])
    nsp_logits = pooled @ p["nsp_w"] + p["nsp_b"]
    h = F.gelu(x @ p["mlm_w"] + p["mlm_b"], approximate="tanh")
    h = _ln(h, p["mlm_ln_w"], p["mlm_ln_b"])
    return tp.copy_to(h, group) @ p["wte"].T + p["mlm_bias"], nsp_logits


def bert_pretrain_loss(model, input_ids, mlm_labels, nsp_labels,
                       attention_mask=None):
    """MLM (labels -100 ignored) + NSP cross entropy, f32 softmax.
    ``attention_mask`` (B, S), 1 = real token: the padded-batch pretrain
    layout.  At mp > 1 the MLM term is the vocabulary-parallel CE of each
    rank's logit columns."""
    group = getattr(model, "_mp_group", None)
    if group is None:
        mlm_logits, nsp_logits = model(input_ids,
                                       attention_mask=attention_mask)
    else:
        mlm_logits, nsp_logits = model._local(input_ids,
                                              attention_mask=attention_mask)
    mlm_logits, nsp_logits = amp_cast_for_op("bert_pretrain_loss",
                                             [mlm_logits, nsp_logits])
    dev = mlm_logits.device
    labels = torch.as_tensor(mlm_labels, device=dev).long()
    nsp_labels = torch.as_tensor(nsp_labels, device=dev).long()
    lg = mlm_logits.float()
    flat = labels.reshape(-1)
    rank = 0 if group is None else group.rank
    per = tp.vocab_parallel_ce(lg.reshape(flat.shape[0], -1), flat,
                               rank * lg.shape[-1], group)
    valid = (flat >= 0).float()
    mlm = (per * valid).sum() / valid.sum().clamp_min(1.0)
    ng = nsp_logits.float()
    nsp = (torch.logsumexp(ng, dim=-1)
           - ng.gather(-1, nsp_labels[:, None])[:, 0]).mean()
    return mlm + nsp


Ernie = Bert
