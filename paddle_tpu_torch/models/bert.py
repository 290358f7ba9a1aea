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
the GPT port: a Python loop over layers stands in for ``lax.scan``, and
BERT has no tensor-parallel path: its parameters carry the reference's
``DistAttr``s (``:94-120``), and ``ShardedTrainStep`` on a mesh with
``mp`` > 1 refuses them (ROADMAP item 3d) rather than keep them whole.

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
from paddle_tpu_torch.parallel.mesh import DistAttr

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


class Bert(Layer):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        for name, value in init_params(config).items():
            p = Parameter(torch.from_numpy(value).to(dev), name=f"bert.{name}")
            if name in DIST_ATTRS:
                p.dist_attr = DistAttr(DIST_ATTRS[name])
            self.register_parameter(name, p)

    def load_jax_params(self, np_params: dict) -> "Bert":
        """Copy the reference model's parameters in (``np.asarray`` of
        each ``model._parameters[n]._data``), keyed by ``_PARAM_ORDER``."""
        from paddle_tpu_torch.models.convert import params_from_jax
        with torch.no_grad():
            for name, t in params_from_jax(np_params, _PARAM_ORDER).items():
                p = getattr(self, name)
                if p.shape != t.shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)} does "
                                     f"not match {tuple(p.shape)}")
                p.copy_(t)
        return self

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """input_ids (B, S) int, optional token_type_ids (B, S) and
        attention_mask (B, S) (1 = real token) -> (mlm_logits (B, S, V),
        nsp_logits (B, 2))."""
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
                                 ids, tt, cast[-1])


def _ln(x, w, b, eps=1e-12):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _flash_ok(cfg: BertConfig, b, s, bias, dtype=None) -> bool:
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    return cfg.use_flash_attention and _fa.supported(
        shape, shape, bias is None,
        bias_shape=None if bias is None else tuple(bias.shape), dtype=dtype)


def _layer(cfg: BertConfig, x, lp, bias):
    b, s = x.shape[:2]
    H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    qkv = x @ lp["qkv_w"] + lp["qkv_b"]
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(H, dim=-1))
    if _flash_ok(cfg, b, s, bias, q.dtype):
        a = _fa.flash_attention(q, k, v, scale=scale, bias=bias)
    else:
        a = _xla_attention(q, k, v, bias, scale, False)
    # post-LN (original BERT): LN(x + sublayer(x))
    x = _ln(x + a.reshape(b, s, H) @ lp["prj_w"] + lp["prj_b"], lp["ln1_w"],
            lp["ln1_b"])
    ff = F.gelu(x @ lp["fc_w"] + lp["fc_b"], approximate="tanh")
    return _ln(x + ff @ lp["out_w"] + lp["out_b"], lp["ln2_w"], lp["ln2_b"])


def _bert_forward(cfg: BertConfig, p: dict, ids, tt, mask,
                  features_only: bool = False):
    """The forward over the parameters ``p`` ({name in _PARAM_ORDER:
    tensor}); with ``features_only`` the last layer's hidden states (B,
    S, H)."""
    S = ids.shape[1]
    x = p["wte"][ids] + p["wpe"][:S][None] + p["wtt"][tt]
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
        x = layer(cfg, x, {n: per_layer[n][i] for n in _LAYER_PARAMS}, bias)
    if features_only:
        return x
    pooled = torch.tanh(x[:, 0] @ p["pool_w"] + p["pool_b"])
    nsp_logits = pooled @ p["nsp_w"] + p["nsp_b"]
    h = F.gelu(x @ p["mlm_w"] + p["mlm_b"], approximate="tanh")
    h = _ln(h, p["mlm_ln_w"], p["mlm_ln_b"])
    return h @ p["wte"].T + p["mlm_bias"], nsp_logits


def bert_pretrain_loss(model, input_ids, mlm_labels, nsp_labels,
                       attention_mask=None):
    """MLM (labels -100 ignored) + NSP cross entropy, f32 softmax.
    ``attention_mask`` (B, S), 1 = real token: the padded-batch pretrain
    layout."""
    mlm_logits, nsp_logits = model(input_ids, attention_mask=attention_mask)
    mlm_logits, nsp_logits = amp_cast_for_op("bert_pretrain_loss",
                                             [mlm_logits, nsp_logits])
    dev = mlm_logits.device
    labels = torch.as_tensor(mlm_labels, device=dev).long()
    nsp_labels = torch.as_tensor(nsp_labels, device=dev).long()
    lg = mlm_logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    mlm = ((logz - gold) * valid).sum() / valid.sum().clamp_min(1.0)
    ng = nsp_logits.float()
    nsp = (torch.logsumexp(ng, dim=-1)
           - ng.gather(-1, nsp_labels[:, None])[:, 0]).mean()
    return mlm + nsp


Ernie = Bert
