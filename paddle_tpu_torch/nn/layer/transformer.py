"""Transformer layers (port of paddle_tpu/nn/layer/transformer.py):
``MultiHeadAttention`` with its ``Cache`` / ``StaticCache`` and
``gen_cache``, ``TransformerEncoderLayer``, ``TransformerEncoder``,
``TransformerDecoderLayer``, ``TransformerDecoder`` and ``Transformer``
with ``generate_square_subsequent_mask``.

Attention goes through ``nn.functional.scaled_dot_product_attention``:
the flash kernel where its rule serves the call (masked calls included),
the dense path otherwise.  An ``attn_mask`` that requires a gradient, a
learned additive bias, receives one from the dbias kernel; a padding mask
never launches it.  Dotted parameter names are the reference's
``named_parameters()`` names (``layers.0.self_attn.q_proj.weight``, ...),
so its weights carry across with models/convert.py ``load_named_params``.
Layers are created on the card unless ``device="cpu"`` is asked for.

An incremental ``Cache`` starts empty in the dtype of the key projection's
weight, so a bf16 model's keys and values stay bf16 as they are appended;
the reference starts it f32 (``:66-69``) and its concatenation promotes
them.
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import Dropout, Linear
from paddle_tpu_torch.nn.layer.layers import Layer, LayerList
from paddle_tpu_torch.nn.layer.norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    """(B, S, E) multi-head attention with q, k, v and output projections
    (reference ``:36``).  ``dropout`` applies to the attention output in
    training mode, drawn from ``generator``."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.generator = generator
        dev = resolve_device(device)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               device=dev)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of the projected key and value, or an empty
        ``Cache`` that each call extends."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return self.StaticCache(k, v)
        w = self.k_proj.weight
        empty = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                            dtype=w.dtype, device=w.device)
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        new_cache = None
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                new_cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None:
            return out, new_cache
        return out


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual and a
    layer norm, post-norm unless ``normalize_before`` (reference
    ``:100``).  ``activation`` names a function of nn.functional ("relu"
    or "gelu"); the dropouts draw from ``generator``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        if not hasattr(F, activation):
            raise ValueError(f"activation {activation!r} is not a function "
                             "of paddle_tpu_torch.nn.functional")
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        dev = resolve_device(device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=dev, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=dev)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=dev)
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.act_dropout = Dropout(act_dropout, generator=generator)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self.activation)
        src = self.linear2(self.act_dropout(act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` encoder layers: the one given and fresh clones of it
    (reference ``:147``), then an optional final norm."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory`` and a feed-forward
    block, each with a residual and a layer norm, post-norm unless
    ``normalize_before`` (reference ``:173``).  With ``cache`` (the pair
    :meth:`gen_cache` returns) the self-attention appends to its
    incremental ``Cache`` and the cross-attention reads its
    ``StaticCache``, and the new pair is returned beside the output."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        if not hasattr(F, activation):
            raise ValueError(f"activation {activation!r} is not a function "
                             "of paddle_tpu_torch.nn.functional")
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        dev = resolve_device(device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=dev, generator=generator)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=dev, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=dev)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=dev)
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)
        self.norm3 = LayerNorm(d_model, device=dev)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.act_dropout = Dropout(act_dropout, generator=generator)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(F, self.activation)
        tgt = self.linear2(self.act_dropout(act(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incr_cache, static_cache)

    def gen_cache(self, memory):
        """(an empty incremental ``Cache``, the ``StaticCache`` of
        ``memory``'s projected keys and values) (reference ``:234``)."""
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(Layer):
    """``num_layers`` decoder layers: the one given and fresh clones of it
    (reference ``:241``), then an optional final norm."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Each layer's (incremental, static) cache pair; with ``do_zip``
        the pairs zipped into (incremental caches, static caches)
        (reference ``:264``)."""
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(Layer):
    """An encoder-decoder Transformer (reference ``:288``): by default
    Transformer-base (d_model 512, 8 heads, 6 + 6 layers, FFN 2048,
    dropout 0.1, ReLU, post-norm), with a final norm on each side only when
    ``normalize_before``; ``custom_encoder`` / ``custom_decoder`` replace
    either side."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 generator=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        dev = resolve_device(device)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device=dev, generator=generator)
            enc_norm = (LayerNorm(d_model, device=dev) if normalize_before
                        else None)
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device=dev, generator=generator)
            dec_norm = (LayerNorm(d_model, device=dev) if normalize_before
                        else None)
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """(length, length) f32: 0 on and below the diagonal, -1e9 above
        (reference ``:324``), on the card unless ``device`` says
        otherwise.  An additive bias, not ``is_causal``: attention adds it
        to every score."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, -1e9)


def _clone_layer(layer):
    """A copy of ``layer`` with fresh parameters, as the reference re-draws
    them: every matrix Xavier-uniform, every bias zero, the norms' weights
    kept.  The draws are the port's own (torch's default generator), not
    the reference's."""
    new = copy.deepcopy(layer)
    with torch.no_grad():
        for name, p in new.named_parameters():
            if p.dim() > 1:
                nn.init.xavier_uniform_(p)
            elif name.rsplit(".", 1)[-1] == "bias":
                p.zero_()
    return new
