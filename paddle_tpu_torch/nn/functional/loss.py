"""``cross_entropy``, ``softmax_with_cross_entropy`` and ``nll_loss``
(port of paddle_tpu/nn/functional/loss.py :30-135).

The log-softmax runs in the logits' dtype (bf16 under AMP O2), as in the
reference.  Hard labels of shape (N,) or (N, 1) (the label's ``axis`` of
size 1 is dropped) or soft labels; ``ignore_index`` clamps the gathered
label at 0 and masks its loss; ``weight`` scales each sample by its
label's class weight, and the mean then divides by the sum of the valid
weights (without it, by the count of valid labels).  ``use_softmax=False``
reads the input as probabilities: ``log(max(p, 1e-30))``.  ``nll_loss``
takes (N, C) log-probabilities and applies the same ``ignore_index`` and
``weight`` rules.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp import amp_op

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


@amp_op("cross_entropy")
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
    return _weighted(loss, lab, weight, ignore_index, reduction)


def _weighted(loss, lab, weight, ignore_index, reduction):
    """The per-sample loss with ``ignore_index`` masked out and scaled by
    ``weight[label]``, reduced; the mean divides by the valid weights' sum,
    or by the count of valid labels without ``weight``."""
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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced cross-entropy with the class axis kept as size 1
    (reference ``:67``); with ``return_softmax`` also the softmax."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.dim() == logits.dim() - 1:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


@amp_op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of (N, C) log-probabilities at (N,) labels
    (reference ``:119``)."""
    lab = label.long()
    loss = -torch.gather(input, 1, lab.clamp_min(0)[:, None])[:, 0]
    return _weighted(loss, lab, weight, ignore_index, reduction)
