"""``cross_entropy`` (port of paddle_tpu/nn/functional/loss.py :30-66).

The log-softmax runs in the logits' dtype (bf16 under AMP O2), as in the
reference.  Hard labels of shape (N,) or (N, 1) (the label's ``axis`` of
size 1 is dropped) or soft labels; ``ignore_index`` clamps the gathered
label at 0 and masks its loss; ``weight`` scales each sample by its
label's class weight, and the mean then divides by the sum of the valid
weights (without it, by the count of valid labels).  ``use_softmax=False``
reads the input as probabilities: ``log(max(p, 1e-30))``.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(input.clamp_min(1e-30))
    if soft_label:
        return _reduce(-(label * logp).sum(axis), reduction)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(axis)
    loss = -torch.gather(logp, axis, lab.clamp_min(0).unsqueeze(axis)
                         ).squeeze(axis)
    valid = lab != ignore_index
    loss = torch.where(valid, loss, 0.0)
    if weight is not None:
        wt = torch.where(valid, weight[lab.clamp_min(0)], 0.0)
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / wt.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1.0)
    return _reduce(loss, reduction)
