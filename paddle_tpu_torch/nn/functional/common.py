"""``linear``, ``dropout``, ``embedding``, ``one_hot`` and
``label_smooth`` (port of paddle_tpu/nn/functional/common.py, what the
transformer layers and a label-smoothed seq2seq loss need)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp import amp_cast_for_op, amp_op
from paddle_tpu_torch.framework.replay import note_generator

__all__ = ["linear", "dropout", "embedding", "one_hot", "label_smooth"]


@amp_op("linear")
def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with weight (in_features, out_features), the
    reference's layout (``:19``)."""
    out = x @ weight
    return out if bias is None else out + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Dropout (reference ``:27``): keeps each entry (or each slice along
    ``axis``) with probability 1 - p, drawn from ``generator`` (the
    default generator of x's device when None); ``upscale_in_train``
    divides the kept entries by 1 - p.  The reference's bits come from
    jax.random and are not reproduced: only the distribution is.  Inside
    a recompute region the replay draws the forward's mask
    (``framework.replay.note_generator``)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    if not training or p == 0:
        return x
    (x,) = amp_cast_for_op("dropout", [x])
    if p == 1:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    if generator is not None:
        note_generator(generator)
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


@amp_op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` looked up by the integer ids ``x`` (reference
    ``:77``, the dense path); the rows of ids equal to ``padding_idx`` are
    zero and pass no gradient.  ``sparse=True``, the reference's
    SelectedRows gradient (``:98``), has no counterpart in the port and
    raises."""
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True): the SelectedRows gradient is not "
            "ported; use sparse=False")
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


@amp_op("one_hot")
def one_hot(x, num_classes, name=None):
    """f32 one-hot rows of the integer ids ``x`` (reference ``:143``, as
    ``jax.nn.one_hot``: an id outside [0, num_classes) gives a zero row)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(torch.float32)


@amp_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) * label + epsilon * prior_dist, the prior uniform over
    the last axis when not given (reference ``:376``)."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]
