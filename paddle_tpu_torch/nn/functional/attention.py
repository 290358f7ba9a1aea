"""Attention functionals (port of paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` and ``flash_attention`` take the
blockwise kernel (ops/cuda/flash_attention.py) where its rule
(``supported``) serves the call, masked calls included, and the dense
fallback ``_xla_attention`` otherwise.  The dispatch is by rule and device:
the reference's ``try/except Exception`` around its kernel is not copied, so
a kernel that cannot run raises.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.amp import amp_op
from paddle_tpu_torch.nn.functional.common import dropout as _dropout
from paddle_tpu_torch.ops.cuda import flash_attention as _fa

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "_xla_attention"]


def _xla_attention(q, k, v, mask, scale, causal):
    """Dense attention on (B, S, H, D) q, k, v (reference ``:24-42``).

    Masked scores are clamped to -1e30, not -inf, so a row with no
    visible key attends uniformly, as the reference's fallback does.  The
    scores are masked and normalised in f32 (where f16 cannot hold
    -1e30)."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    scores = (torch.einsum("bhsd,bhtd->bhst", qh, kh) * scale).float()
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=scores.device).tril(s_k - s_q)
        scores = scores.masked_fill(~keep, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, -1e30)
        else:
            scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bhtd->bhsd", probs, vh)
    return out.permute(0, 2, 1, 3)


@amp_op("sdp_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """(B, S, H, D) attention (reference ``:45``).  A bool or additive
    ``attn_mask`` broadcastable to (B, H, Sq, Sk) rides the kernel as a
    bias.  A mask that requires a gradient (a learned bias) receives one
    from the dbias kernel; one that does not (a padding mask) never
    launches it, as the reference's ``bias_grad=not stop_gradient`` splits
    it.  Dropout, when ``dropout_p > 0`` and ``training``, applies to the
    output with ``generator``, as the reference's does."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    if _fa.supported(tuple(query.shape), tuple(key.shape), attn_mask is None,
                     causal=is_causal,
                     bias_shape=None if attn_mask is None
                     else tuple(attn_mask.shape), dtype=query.dtype):
        out = _fa.flash_attention(query, key, value, causal=is_causal,
                                  scale=scale, bias=attn_mask)
    else:
        out = _xla_attention(query, key, value, attn_mask, scale, is_causal)
    if dropout_p > 0.0 and training:
        out = _dropout(out, p=dropout_p, generator=generator)
    return out


@amp_op("flash_attention")
def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, attn_mask=None,
                    q_segment_ids=None, kv_segment_ids=None, name=None,
                    generator=None):
    """Flash attention with segment ids (reference ``:105``):
    ``q_segment_ids``/``kv_segment_ids`` ((B, S) int) hide the pairs whose
    ids differ (packed sequences).  The kernel evaluates them in its tiles;
    the dense fallback materialises the equivalent -1e30 bias.  The mask
    of a segmented call takes no gradient, as in the reference."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: pass both q_segment_ids and "
                         "kv_segment_ids, or neither")
    if q_segment_ids is None:
        out = scaled_dot_product_attention(query, key, value,
                                           attn_mask=attn_mask,
                                           dropout_p=dropout,
                                           is_causal=causal,
                                           generator=generator)
        return (out, None) if return_softmax else out
    scale = 1.0 / math.sqrt(query.shape[-1])
    qs = torch.as_tensor(q_segment_ids, device=query.device)
    ks = torch.as_tensor(kv_segment_ids, device=query.device)
    mask = None if attn_mask is None else attn_mask.detach()
    if _fa.supported(tuple(query.shape), tuple(key.shape), mask is None,
                     causal=causal, segments=True,
                     bias_shape=None if mask is None else tuple(mask.shape),
                     dtype=query.dtype):
        out = _fa.flash_attention(query, key, value, causal=causal,
                                  scale=scale, bias=mask, q_segment_ids=qs,
                                  kv_segment_ids=ks)
    else:
        seg = qs[:, None, :, None] == ks[:, None, None, :]
        bias = torch.where(seg, 0.0, -1e30)
        if mask is not None:
            bias = bias + (torch.where(mask, 0.0, -1e30)
                           if mask.dtype == torch.bool else mask)
        out = _xla_attention(query, key, value, bias, scale, causal)
    if dropout > 0.0:
        out = _dropout(out, p=dropout, generator=generator)
    return (out, None) if return_softmax else out
