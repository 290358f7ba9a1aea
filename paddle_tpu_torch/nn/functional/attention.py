"""Attention functionals (port of paddle_tpu/nn/functional/attention.py).

Only the dense fallback of this slice: the blockwise kernel lives in
ops/cuda/flash_attention.py.
"""
from __future__ import annotations

import torch

__all__ = ["_xla_attention"]


def _xla_attention(q, k, v, mask, scale, causal):
    """Dense attention on (B, S, H, D) q, k, v (reference ``:24-42``).

    Masked scores are clamped to -1e30, not -inf, so a row with no
    visible key attends uniformly, as the reference's fallback does."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    scores = torch.einsum("bhsd,bhtd->bhst", qh, kh) * scale
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
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bhtd->bhsd", probs, vh)
    return out.permute(0, 2, 1, 3)
