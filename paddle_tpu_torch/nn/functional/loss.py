"""The losses (port of paddle_tpu/nn/functional/loss.py).

``cross_entropy``, ``softmax_with_cross_entropy`` and ``nll_loss``
(``:30-135``):

The log-softmax runs in the logits' dtype (bf16 under AMP O2), as in the
reference.  Hard labels of shape (N,) or (N, 1) (the label's ``axis`` of
size 1 is dropped) or soft labels; ``ignore_index`` clamps the gathered
label at 0 and masks its loss; ``weight`` scales each sample by its
label's class weight, and the mean then divides by the sum of the valid
weights (without it, by the count of valid labels).  ``use_softmax=False``
reads the input as probabilities: ``log(max(p, 1e-30))``.  ``nll_loss``
takes (N, C) log-probabilities and applies the same ``ignore_index`` and
``weight`` rules.

The others follow the reference's formulas and its reductions (``_reduce``
:22-28: ``mean``, ``sum``, anything else unreduced); ``max(0, .)`` is
``torch.maximum``, whose gradient splits at a tie as JAX's does.

``ctc_loss`` (``:270-325``) runs the reference's alpha recursion over the
log-softmax of its (T, N, C) logits (warpctc's contract), in the log domain
with ``NEG = -1e30`` for an impossible state, one step a time frame,
frozen past each input length:

- the loss is ``-logaddexp(alpha[2L], alpha[2L - 1])`` at label length
  L, the second index clamped at 0.  An empty label therefore scores
  ``-log(2 p)``, p the all-blank path's probability: the two terms are the
  same alpha (PyTorch's ``F.ctc_loss`` gives ``-log p``);
- an alignment no path reaches keeps a finite loss near 1e30, where
  ``F.ctc_loss`` gives ``inf``, and its gradient is the reference's:
  ``logaddexp`` differentiates as JAX's does (``_LogAddExp``);
- ``'mean'`` divides each loss by ``max(label_length, 1)`` before the
  mean; ``norm_by_times`` is read by nothing.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp import amp_op

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "l1_loss", "mse_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "ctc_loss", "square_error_cost", "log_loss",
    "sigmoid_focal_loss", "dice_loss", "npair_loss", "triplet_margin_loss",
    "soft_margin_loss",
]


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


def _relu(x):
    """max(0, x) with JAX's gradient: half of it at x == 0."""
    return torch.maximum(x, x.new_zeros(()))


def _softplus_abs(z):
    """log(1 + exp(-|z|))."""
    return torch.log1p(torch.exp(-z.abs()))


@amp_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    # jnp.clip's gradient: half of it at a bound, as at a tie of max / min
    p = torch.minimum(torch.maximum(input, input.new_tensor(1e-12)),
                      input.new_tensor(1.0 - 1e-12))
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, lab = logit, label
    if pos_weight is not None:
        l_w = 1.0 + (pos_weight - 1.0) * lab
        loss = (1.0 - lab) * z + l_w * (_softplus_abs(z) + _relu(-z))
    else:
        loss = _relu(z) - z * lab + _softplus_abs(z)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("l1_loss")
def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


@amp_op("mse_loss")
def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) ** 2, reduction)


@amp_op("square_error_cost")
def square_error_cost(input, label, name=None):
    return (input - label) ** 2


@amp_op("log_loss")
def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


@amp_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = input - label
    loss = torch.where(d.abs() < delta, 0.5 * d * d,
                       delta * (d.abs() - 0.5 * delta))
    return _reduce(loss, reduction)


@amp_op("kl_div")
def kl_div(input, label, reduction="mean", name=None):
    """label * (log(label) - input), input the log-probabilities;
    ``batchmean`` divides the sum by the batch."""
    loss = label * (torch.log(torch.maximum(label, label.new_tensor(1e-30)))
                    - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@amp_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(_relu(-label * (input - other) + margin), reduction)


@amp_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1.0, input, _relu(margin - input))
    return _reduce(loss, reduction)


@amp_op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    norms = (torch.linalg.vector_norm(input1, dim=-1)
             * torch.linalg.vector_norm(input2, dim=-1))
    cos = (input1 * input2).sum(-1) / torch.maximum(
        norms, norms.new_tensor(1e-12))
    loss = torch.where(label == 1, 1.0 - cos, _relu(cos - margin))
    return _reduce(loss, reduction)


@amp_op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, lab = logit, label
    p = torch.sigmoid(z)
    ce = _relu(z) - z * lab + _softplus_abs(z)
    p_t = p * lab + (1 - p) * (1 - lab)
    a_t = alpha * lab + (1 - alpha) * (1 - lab)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@amp_op("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - (2 |p . onehot| + eps) / (|p| + |onehot| + eps) per sample,
    averaged; ``label`` (..., 1) class ids."""
    onehot = (label[..., 0].long()[..., None] == torch.arange(
        input.shape[-1], device=input.device)).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = 2.0 * (input * onehot).sum(dims)
    denom = input.sum(dims) + onehot.sum(dims)
    return (1.0 - (inter + epsilon) / (denom + epsilon)).mean()


@amp_op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    sim = anchor @ positive.T
    lab = labels.reshape(-1)
    tgt = (lab[:, None] == lab[None, :]).to(sim.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    ce = -(tgt * torch.log_softmax(sim, dim=1)).sum(1).mean()
    reg = l2_reg * ((anchor * anchor).sum(1).mean()
                    + (positive * positive).sum(1).mean()) * 0.25
    return ce + reg


@amp_op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return ((u - v + epsilon).abs() ** p).sum(-1) ** (1.0 / p)
    d_ap = dist(input, positive)
    d_an = dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    return _reduce(_relu(d_ap - d_an + margin), reduction)


@amp_op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


_NEG = -1e30


def _no_posinf(x):
    return torch.where(torch.isposinf(x), 0.0, x)


class _LogAddExp(torch.autograd.Function):
    """logaddexp with JAX's derivative, ``exp(x - out)`` for each input.
    Where both inputs sit at -1e30 the sum rounds back onto them and each
    input takes the whole gradient (PyTorch's rule gives each half), which
    is what an unreachable CTC state passes back in the reference."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        out = _no_posinf(out)
        return (g * torch.exp(_no_posinf(a) - out),
                g * torch.exp(_no_posinf(b) - out))


@amp_op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over (T, N, C) logits and (N, S) padded labels (module
    docstring)."""
    lp = torch.log_softmax(log_probs, dim=-1)
    t_len, n, _ = lp.shape
    s = labels.shape[1]
    dev = lp.device
    lab_len = label_lengths.long()
    ext = torch.full((n, 2 * s + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    rows = torch.arange(n, device=dev)
    neg = torch.full((n, 2 * s + 1), _NEG, dtype=lp.dtype, device=dev)
    first = torch.where(lab_len > 0, ext[:, 1], blank)
    alpha = torch.cat([lp[0, rows, blank][:, None],
                       torch.where(lab_len > 0, lp[0, rows, first],
                                   _NEG)[:, None], neg[:, 2:]],
                      dim=1)[:, :2 * s + 1]
    skip = torch.cat([torch.ones((n, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    emit = lp.gather(2, ext[None].expand(t_len, -1, -1))
    active = torch.arange(t_len, device=dev)[:, None] < input_lengths.to(
        dev).long()[None, :]
    for t in range(1, t_len):
        shift1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg[:, :2], alpha[:, :-2]], dim=1).masked_fill(
            skip, _NEG)
        merged = _LogAddExp.apply(_LogAddExp.apply(alpha, shift1), shift2)
        alpha = torch.where(active[t][:, None], merged + emit[t], alpha)
    last = (2 * lab_len).clamp_min(0)
    prev = (2 * lab_len - 1).clamp_min(0)
    loss = -_LogAddExp.apply(alpha.gather(1, last[:, None])[:, 0],
                             alpha.gather(1, prev[:, None])[:, 0])
    if reduction == "mean":
        return (loss / lab_len.to(loss.dtype).clamp_min(1.0)).mean()
    return _reduce(loss, reduction)
