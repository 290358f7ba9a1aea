"""GPT — the flagship decoder-only LM (port of paddle_tpu/models/gpt.py).

Logits through :meth:`GPT.forward` and the causal-LM loss through
:func:`gpt_loss`, with the fused linear+CE head when ``FLAGS_gpt_fused_ce``
is set.  Both record on autograd's tape, as the reference's forward
records on its own: gradients flow through the flash kernels (S >= 128),
the dense fallback (S < 128) and the fused head's dh and dW kernels; the
tied ``wte`` receives the embedding's gradient and the head's, which
autograd sums.  Serving callers wrap their calls in
``torch.inference_mode()``.

What is the same as the reference: the configuration and presets, the
stacked (L, ...) parameters with the same names, shapes and numpy draws
(``np.random.default_rng(seed)`` in the same order), pre-LN layers with
tanh-GELU, the tied head, the loss conventions, and ``remat`` (the
default): each layer is one recompute region under autograd
(``jit/recompute.py``, the reference's ``jax.checkpoint(layer)``,
``:218``), its activations rebuilt in the backward, while the embedding,
the final LN and the head keep theirs.  ``bench.py``'s GPT-2 legs run
``remat=False``.  What differs: a Python loop over layers stands in for
``lax.scan`` (``scan_unroll`` is accepted and means nothing in eager
PyTorch), and there are no meshes, shardings, pipeline or ring
attention.

Attention dispatches by rule, not by catching errors: sequences the
blockwise kernel serves (``flash_attention.supported``: head dim 64 or
128, f32 or bf16) take it — the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor — and the rest (S < 128, f16, other head dims)
take the dense fallback.  The
reference wraps its kernel in ``try/except Exception: pass`` and falls
back silently; the port does not: a kernel that cannot run raises.

Mixed precision: ``model.to(torch.bfloat16)`` casts the parameters for
serving; training keeps f32 parameters and casts a copy per step
(``jit.TrainStep(amp_level="O2")``), or trains bf16 parameters eagerly
after ``amp.decorate(level="O2")``.  Activations then run in bf16 and the
loss casts logits to f32.  Under ``amp.auto_cast`` the forward is one op,
``gpt_forward``, in neither list (O1 runs it as it comes, O2 casts the
parameters at its boundary), as are ``gpt_loss`` over the logits and
``gpt_loss_fused``.
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
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.jit.recompute import recompute
from paddle_tpu_torch.nn.functional.attention import _xla_attention
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.ops.cuda import flash_attention as _fa
from paddle_tpu_torch.ops.cuda import fused_ce

__all__ = ["GPTConfig", "GPT", "gpt_loss", "gpt_tiny", "gpt2_small",
           "gpt2_medium", "gpt2_345m"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=1024, num_layers=24,
                 num_heads=16, ffn_size: Optional[int] = None,
                 max_seq_len=1024, initializer_range=0.02,
                 remat: bool = True, n_microbatches: int = 1,
                 use_flash_attention: bool = True, seed: int = 0,
                 schedule_mode: int = 0, scan_unroll: int = 1):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.initializer_range = initializer_range
        # recompute each layer in the backward (jit/recompute.py)
        self.remat = remat
        # accepted for parity with the reference; the port runs a Python
        # loop over layers and has no pipeline or schedule
        self.n_microbatches = n_microbatches
        self.use_flash_attention = use_flash_attention
        self.seed = seed
        self.schedule_mode = schedule_mode
        self.scan_unroll = scan_unroll

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def gpt_tiny(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 4)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_seq_len", 128)
    return GPTConfig(**kw)


def gpt2_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt2_medium(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


# "GPT-2 345M" — the flagship configuration
gpt2_345m = gpt2_medium


# fixed parameter order (the reference's pure-forward argument order)
_PARAM_ORDER = ("wte", "wpe", "ln1_w", "ln1_b", "qkv_w", "qkv_b", "prj_w",
                "prj_b", "ln2_w", "ln2_b", "fc_w", "fc_b", "out_w", "out_b",
                "lnf_w", "lnf_b")
_LAYER_PARAMS = _PARAM_ORDER[2:14]


def init_params(c: GPTConfig) -> dict:
    """The reference's initial parameters as numpy arrays: the same
    ``default_rng(seed)`` draws in the same order (gpt.py:107-140)."""
    rng = np.random.default_rng(c.seed)
    std = c.initializer_range
    L, H, F_, V, S = (c.num_layers, c.hidden_size, c.ffn_size,
                      c.vocab_size, c.max_seq_len)

    def norm(shape, scale=std):
        return rng.standard_normal(shape).astype(np.float32) * scale

    p = {}
    p["wte"] = norm((V, H))
    p["wpe"] = norm((S, H))
    p["ln1_w"] = np.ones((L, H), np.float32)
    p["ln1_b"] = np.zeros((L, H), np.float32)
    p["qkv_w"] = norm((L, H, 3 * H))
    p["qkv_b"] = np.zeros((L, 3 * H), np.float32)
    # GPT-2 residual-projection scaling: std/sqrt(2L)
    p["prj_w"] = norm((L, H, H), std / math.sqrt(2 * L))
    p["prj_b"] = np.zeros((L, H), np.float32)
    p["ln2_w"] = np.ones((L, H), np.float32)
    p["ln2_b"] = np.zeros((L, H), np.float32)
    p["fc_w"] = norm((L, H, F_))
    p["fc_b"] = np.zeros((L, F_), np.float32)
    p["out_w"] = norm((L, F_, H), std / math.sqrt(2 * L))
    p["out_b"] = np.zeros((L, H), np.float32)
    p["lnf_w"] = np.ones((H,), np.float32)
    p["lnf_b"] = np.zeros((H,), np.float32)
    return p


class GPT(Layer):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        for name, value in init_params(config).items():
            self.register_parameter(
                name, Parameter(torch.from_numpy(value).to(dev),
                                name=f"gpt.{name}"))

    def load_jax_params(self, np_params: dict) -> "GPT":
        """Copy the reference model's parameters in (``np.asarray`` of
        each ``model._parameters[n]._data``), keyed by ``_PARAM_ORDER``."""
        from paddle_tpu_torch.models.convert import params_from_jax
        with torch.no_grad():
            for name, t in params_from_jax(np_params).items():
                p = getattr(self, name)
                if p.shape != t.shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)} does "
                                     f"not match {tuple(p.shape)}")
                p.copy_(t)
        return self

    def forward(self, input_ids) -> torch.Tensor:
        """input_ids (B, S) int -> logits (B, S, V).  One op for
        ``amp.auto_cast``, as the reference's ``gpt_forward``."""
        ids = self._ids(input_ids)
        params = amp_cast_for_op("gpt_forward", self._param_list())
        with _op_scope():
            return _gpt_forward(self.config, dict(zip(_PARAM_ORDER, params)),
                                ids)

    def _param_list(self) -> list:
        return [getattr(self, n) for n in _PARAM_ORDER]

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, device=self.wte.device).long()


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _attention(cfg: GPTConfig, q, k, v):
    """(B, S, nh, hd) causal attention: the blockwise kernel where the
    reference's rule sends it, else the dense fallback."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if cfg.use_flash_attention and _fa.supported(
            tuple(q.shape), tuple(k.shape), causal=True, dtype=q.dtype):
        return _fa.flash_attention(q, k, v, causal=True, scale=scale)
    return _xla_attention(q, k, v, None, scale, True)


def _layer(cfg: GPTConfig, x, lp):
    b, s = x.shape[:2]
    H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    h = _ln(x, lp["ln1_w"], lp["ln1_b"])
    qkv = h @ lp["qkv_w"] + lp["qkv_b"]                 # (b,s,3H)
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(H, dim=-1))
    a = _attention(cfg, q, k, v).reshape(b, s, H)
    x = x + a @ lp["prj_w"] + lp["prj_b"]
    h2 = _ln(x, lp["ln2_w"], lp["ln2_b"])
    ff = F.gelu(h2 @ lp["fc_w"] + lp["fc_b"], approximate="tanh")
    return x + ff @ lp["out_w"] + lp["out_b"]


def _gpt_forward(cfg: GPTConfig, p: dict, ids, features_only: bool = False):
    """The forward over the parameters ``p`` ({name in _PARAM_ORDER:
    tensor})."""
    S = ids.shape[1]
    x = p["wte"][ids] + p["wpe"][:S][None, :, :]
    # one unbind per stacked parameter: its backward is one stack, where
    # indexing each layer would sum L full-size gradients per parameter
    per_layer = {n: p[n].unbind(0) for n in _LAYER_PARAMS}
    layer = functools.partial(recompute, _layer) if cfg.remat else _layer
    for i in range(cfg.num_layers):
        x = layer(cfg, x, {n: per_layer[n][i] for n in _LAYER_PARAMS})
    x = _ln(x, p["lnf_w"], p["lnf_b"])
    if features_only:
        return x
    return x @ p["wte"].T                              # tied head


def _gpt_fused_ce_loss(cfg: GPTConfig, p: dict, ids, labels):
    """Forward to the final LN, then the fused linear+CE head against the
    tied embedding (reference ``:335-353``)."""
    B, S = ids.shape
    h = _gpt_forward(cfg, p, ids, features_only=True)  # (B,S,H)
    # next-token labels with a -1 sentinel on the final position
    lab = torch.cat([labels[:, 1:], labels.new_full((B, 1), -1)], dim=1)
    lab_flat = lab.reshape(B * S)
    loss_n = fused_ce.fused_linear_cross_entropy(
        h.reshape(B * S, h.shape[-1]), p["wte"], lab_flat)
    w = (lab_flat >= 0).float()
    return (loss_n * w).sum() / (B * (S - 1))


def gpt_loss(model: GPT, input_ids, labels):
    """Causal-LM cross entropy (f32 softmax); labels == input tokens,
    shifted internally.  With ``FLAGS_gpt_fused_ce`` the head and CE run as
    the fused kernel where its rule takes the head (``fused_ce.supported``:
    f32 or bf16), and the (B, S, V) logits are never materialised."""
    cfg = model.config
    ids, labels = model._ids(input_ids), model._ids(labels)
    B, S = ids.shape
    if flag("gpt_fused_ce") and fused_ce.supported(
            B * S, cfg.hidden_size, model.wte.dtype):
        params = amp_cast_for_op("gpt_loss_fused", model._param_list())
        with _op_scope():
            return _gpt_fused_ce_loss(
                cfg, dict(zip(_PARAM_ORDER, params)), ids, labels)
    (logits,) = amp_cast_for_op("gpt_loss", [model(ids)])
    lg = logits[:, :-1].float()
    tg = labels[:, 1:]
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, tg[..., None])[..., 0]
    return (logz - gold).mean()
