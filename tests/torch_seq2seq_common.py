"""Shared helpers of the seq2seq tests: one encoder-decoder composition
built of public layers, the same in both packages (source and target
``Embedding``s, learned position ``Embedding``s, the ``Transformer``, a
``Linear`` head), its label-smoothed loss, its batch and masks, and the
beam-search cell that decodes it.  The JAX package has no seq2seq model
class, so neither does the port: the composition lives here and in
``chip_smoke.py``.  Weights carry from the reference to the port by
``named_parameters()`` names (``models.load_named_params``)."""
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch.models import load_named_params

PAD, START, END = 0, 1, 2
EPS = 0.1                  # label smoothing, as the translation recipe
# the small composition: 2 + 2 layers, d_model 128, 2 heads of 64
SMALL = dict(vocab=512, d_model=128, nhead=2, layers=2, ffn=256,
             max_len=256)


class JSeq2Seq(jnn.Layer):
    """The reference's composition."""

    def __init__(self, vocab, d_model, nhead, layers, ffn, max_len,
                 dropout=0.0, normalize_before=False):
        super().__init__()
        self.src_emb = jnn.Embedding(vocab, d_model)
        self.tgt_emb = jnn.Embedding(vocab, d_model)
        self.src_pos = jnn.Embedding(max_len, d_model)
        self.tgt_pos = jnn.Embedding(max_len, d_model)
        self.transformer = jnn.Transformer(
            d_model, nhead, layers, layers, ffn, dropout,
            normalize_before=normalize_before)
        self.head = jnn.Linear(d_model, vocab)

    def embed(self, emb, pos, ids):
        return emb(ids) + pos(paddle.arange(ids.shape[1]))

    def forward(self, src, tgt, src_mask, tgt_mask, memory_mask):
        out = self.transformer(self.embed(self.src_emb, self.src_pos, src),
                               self.embed(self.tgt_emb, self.tgt_pos, tgt),
                               src_mask, tgt_mask, memory_mask)
        return self.head(out)


class TSeq2Seq(torch.nn.Module):
    """The port's composition (``chip_smoke.seq2seq_model`` builds the
    same)."""

    def __init__(self, vocab, d_model, nhead, layers, ffn, max_len,
                 dropout=0.0, normalize_before=False, device="cpu",
                 generator=None):
        super().__init__()
        self.src_emb = tnn.Embedding(vocab, d_model, device=device)
        self.tgt_emb = tnn.Embedding(vocab, d_model, device=device)
        self.src_pos = tnn.Embedding(max_len, d_model, device=device)
        self.tgt_pos = tnn.Embedding(max_len, d_model, device=device)
        self.transformer = tnn.Transformer(
            d_model, nhead, layers, layers, ffn, dropout,
            normalize_before=normalize_before, device=device,
            generator=generator)
        self.head = tnn.Linear(d_model, vocab, device=device)

    def embed(self, emb, pos, ids):
        return emb(ids) + pos(torch.arange(ids.shape[1], device=ids.device))

    def forward(self, src, tgt, src_mask, tgt_mask, memory_mask):
        out = self.transformer(self.embed(self.src_emb, self.src_pos, src),
                               self.embed(self.tgt_emb, self.tgt_pos, tgt),
                               src_mask, tgt_mask, memory_mask)
        return self.head(out)


def named(layer):
    return {n: np.array(p._data) for n, p in layer.named_parameters()}


def pair(cfg=SMALL, seed=0, **kw):
    """(reference composition drawn from ``seed``, port composition with
    its weights)."""
    paddle.seed(seed)
    ref = JSeq2Seq(**cfg, **kw)
    port = TSeq2Seq(**cfg, **kw)
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    return ref, load_named_params(port, named(ref))


def j_loss(model, src, tgt, label, src_mask, tgt_mask, memory_mask):
    """Label-smoothed soft-label cross-entropy, padding weighted out."""
    logits = model(src, tgt, src_mask, tgt_mask, memory_mask)
    soft = jF.label_smooth(jF.one_hot(label, logits.shape[-1]), epsilon=EPS)
    ce = jF.cross_entropy(logits, soft, soft_label=True, reduction="none")
    w = (label != PAD).astype("float32")
    return (ce * w).sum() / w.sum()


def t_loss(model, src, tgt, label, src_mask, tgt_mask, memory_mask):
    logits = model(src, tgt, src_mask, tgt_mask, memory_mask)
    soft = tF.label_smooth(tF.one_hot(label, logits.shape[-1]), epsilon=EPS)
    ce = tF.cross_entropy(logits, soft, soft_label=True, reduction="none")
    w = (label != PAD).to(ce.dtype)
    return (ce * w).sum() / w.sum()


def batch(seed, b=2, vocab=SMALL["vocab"], s_src=256, s_tgt=128):
    """(src, tgt, label, src bias) as numpy: source lengths in [S/2, S],
    target lengths in [T/2, T], ids past a length PAD; tgt is the label
    shifted right behind START; the bias (B, 1, 1, S) f32 is 0 on real
    keys and -1e9 on padding."""
    rng = np.random.default_rng(seed)
    src_len = rng.integers(s_src // 2, s_src + 1, (b,))
    tgt_len = rng.integers(s_tgt // 2, s_tgt + 1, (b,))
    src = rng.integers(3, vocab, (b, s_src))
    label = rng.integers(3, vocab, (b, s_tgt))
    src = np.where(np.arange(s_src) < src_len[:, None], src, PAD)
    label = np.where(np.arange(s_tgt) < tgt_len[:, None], label, PAD)
    tgt = np.concatenate([np.full((b, 1), START), label[:, :-1]], axis=1)
    bias = np.where(np.arange(s_src) < src_len[:, None], 0.0, -1e9)
    return (src.astype(np.int64), tgt.astype(np.int64),
            label.astype(np.int64),
            bias[:, None, None, :].astype(np.float32))


def j_cell(model, memory, memory_mask, beam):
    """The reference's beam-search cell over ``model``'s decoder:
    (token embedding, (caches, positions)) -> (decoder output, states)."""
    mem = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(memory, beam)
    mask = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(memory_mask,
                                                            beam)

    def cell(inputs, states):
        caches, pos = states
        x = paddle.unsqueeze(inputs + model.tgt_pos(pos), 1)
        out, caches = model.transformer.decoder(x, mem, None, mask, caches)
        return out[:, 0], (caches, pos + 1)
    return cell


def t_cell(model, memory, memory_mask, beam):
    """The port's beam-search cell (``chip_smoke.beam_cell`` is the
    same)."""
    mem = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(memory, beam)
    mask = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(memory_mask,
                                                            beam)

    def cell(inputs, states):
        caches, pos = states
        x = (inputs + model.tgt_pos(pos))[:, None]
        out, caches = model.transformer.decoder(x, mem, None, mask, caches)
        return out[:, 0], (caches, pos + 1)
    return cell
