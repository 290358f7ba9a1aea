"""The loss layers (port of paddle_tpu/nn/layer/loss.py): the loss
functionals with their arguments held by a layer, and the two heads that
hold parameters, ``HSigmoidLoss`` and ``NCELoss``.

The heads draw their initial weights, uniform in +-1/sqrt(dim), from
``np.random.default_rng`` as the reference does (seed 0 for
``HSigmoidLoss``, ``seed`` for ``NCELoss``), so both packages start from
the same values; ``NCELoss`` keeps that generator and draws each batch's
negatives from it (uniform ids, the logQ correction ``log(k / V)``), so
both packages sample the same ids in the same order.  Parameters land on
the card unless ``device="cpu"``."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.parameter import Parameter
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "CTCLoss", "SigmoidFocalLoss", "TripletMarginLoss",
           "SoftMarginLoss", "HSigmoidLoss", "NCELoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class _Reduced(Layer):
    """A loss functional of (input, label) and a reduction."""
    _fn = None

    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return self._fn(input, label, self.reduction)


class MSELoss(_Reduced):
    _fn = staticmethod(F.mse_loss)


class L1Loss(_Reduced):
    _fn = staticmethod(F.l1_loss)


class SoftMarginLoss(_Reduced):
    _fn = staticmethod(F.soft_margin_loss)


class KLDivLoss(_Reduced):
    _fn = staticmethod(F.kl_div)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class SigmoidFocalLoss(Layer):
    def __init__(self, alpha=0.25, gamma=2.0, normalizer=None,
                 reduction="sum", name=None):
        super().__init__()
        self.alpha, self.gamma = alpha, gamma
        self.normalizer = normalizer
        self.reduction = reduction

    def forward(self, logit, label):
        return F.sigmoid_focal_loss(logit, label, self.normalizer, self.alpha,
                                    self.gamma, self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


def _uniform_head(rng, rows, dim, bias, prefix, device):
    """(weight, bias) of a head: uniform(+-1/sqrt(dim)) rows from ``rng``,
    a zero bias unless ``bias`` is False."""
    std = 1.0 / max(1.0, dim ** 0.5)
    w = rng.uniform(-std, std, (rows, dim)).astype(np.float32)
    weight = Parameter(torch.from_numpy(w).to(device), name=f"{prefix}_w")
    if bias is False:
        return weight, None
    return weight, Parameter(torch.zeros(rows, device=device),
                             name=f"{prefix}_b")


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid head over the complete binary tree of
    ``num_classes`` leaves (reference ``:185-216``), or over a custom tree
    given to ``forward`` as ``path_table`` / ``path_code``."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.weight, self.bias = _uniform_head(
            np.random.default_rng(0), num_classes - 1, feature_size,
            bias_attr, "hsigmoid", resolve_device(device))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)


class NCELoss(Layer):
    """Noise-contrastive estimation head (reference ``:217-277``): the
    true class against ``num_neg_samples`` uniform noise ids, scores
    corrected by log(k / V); returns the (B, 1) losses."""

    def __init__(self, num_total_classes, dim, num_neg_samples=10,
                 sampler="uniform", weight_attr=None, bias_attr=None, seed=0,
                 name=None, device=None):
        super().__init__()
        if sampler != "uniform":
            raise NotImplementedError("only the uniform sampler is "
                                      "implemented")
        self.num_total_classes = num_total_classes
        self.num_neg_samples = num_neg_samples
        self._rng = np.random.default_rng(seed)
        self.weight, self.bias = _uniform_head(
            self._rng, num_total_classes, dim, bias_attr, "nce",
            resolve_device(device))

    def forward(self, input, label):
        k, v = self.num_neg_samples, self.num_total_classes
        noise = torch.from_numpy(self._rng.integers(
            0, v, size=(int(input.shape[0]), k))).to(input.device)
        cand = torch.cat([label.reshape(-1, 1).long(), noise], dim=1)
        s = torch.einsum("bkd,bd->bk", self.weight[cand], input)
        if self.bias is not None:
            s = s + self.bias[cand]
        s = s - float(np.log(k / v))
        pos = -F.log_sigmoid(s[:, 0])
        neg = -F.log_sigmoid(-s[:, 1:]).sum(1)
        return (pos + neg)[:, None]
