"""The port's beam search (``nn.decode``) against the reference on the CPU:
``gather_tree`` on the reference's example and on random parents,
``tile_beam_merge_with_batch``, and ``BeamSearchDecoder`` +
``dynamic_decode`` (``return_length``, ``output_time_major``) driven by
the small Transformer composition's decoder over its incremental caches
and by an ``LSTMCell``, f32, beam 3, at most 8 steps.  The head's bias on
the end token is raised so that some beams finish and others do not
(1.2), or all finish before the last step (1.6).  Tokens, parents,
lengths and finished flags must be identical to the reference's each
step; log-probs agree within 1e-5 absolute.  The counter cell of
tests/test_decode_nce.py runs as it is there.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core import Tensor
from paddle_tpu.nn.decode import gather_tree as j_gather_tree
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.nn.decode import gather_tree

from torch_seq2seq_common import (END, START, batch, j_cell, named, pair,
                                  t_cell)

ATOL = 1e-5
BEAM, STEPS = 3, 8


def test_gather_tree_reference_example():
    ids = np.array([[[2, 2]], [[6, 1]], [[3, 9]]])
    parents = np.array([[[0, 0]], [[1, 1]], [[0, 0]]])
    got = gather_tree(ids, parents)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), j_gather_tree(ids, parents))
    np.testing.assert_array_equal(got.numpy()[2, 0], [3, 9])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_tree_random_parents(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 50, (9, 4, 5))
    parents = rng.integers(0, 5, (9, 4, 5))
    want = j_gather_tree(ids, parents)
    np.testing.assert_array_equal(gather_tree(ids, parents).numpy(), want)
    np.testing.assert_array_equal(
        gather_tree(torch.from_numpy(ids), torch.from_numpy(parents)).numpy(),
        want)


def test_tile_beam_merge_with_batch():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.from_numpy(x), 2)
    np.testing.assert_array_equal(
        got.numpy(), jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
            Tensor(x), 2).numpy())
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 2], [0, 1, 2],
                                                [3, 4, 5], [3, 4, 5]])


def _steps(dec, inits, to_np):
    """initialize, then up to STEPS steps (stopping when every beam has
    finished, as dynamic_decode does): each step's (token, parent,
    log-probs, finished, lengths) as numpy."""
    inputs, state = dec.initialize(inits)
    out = []
    for t in range(STEPS):
        o, state, inputs, finished = dec.step(t, inputs, state)
        out.append((to_np(o["token"]), to_np(o["parent"]),
                    to_np(state.log_probs), to_np(state.finished),
                    to_np(state.lengths)))
        if to_np(finished).all():
            break
    return out


def _compare_decodes(jdec, tdec, jinits, tinits):
    want = _steps(jdec, jinits, np.asarray)
    got = _steps(tdec, tinits, lambda t: t.numpy())
    assert len(got) == len(want)
    for t, (w, g) in enumerate(zip(want, got)):
        for k in (0, 1, 3, 4):                  # token, parent, flags, len
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"step {t}")
        np.testing.assert_allclose(g[2], w[2], atol=ATOL, rtol=0,
                                   err_msg=f"step {t}")
    jout, jst, jlen = jnn.dynamic_decode(jdec, jinits, max_step_num=STEPS,
                                         return_length=True)
    tout, tst, tlen = tnn.dynamic_decode(tdec, tinits, max_step_num=STEPS,
                                         return_length=True)
    assert tuple(tout.shape) == tuple(jout.shape) == (
        jout.shape[0], len(want), BEAM)
    np.testing.assert_array_equal(tout.numpy(), jout.numpy())
    np.testing.assert_array_equal(tlen.numpy(), jlen.numpy())
    np.testing.assert_array_equal(tst.finished.numpy(), jst.finished)
    np.testing.assert_allclose(tst.log_probs.numpy(), jst.log_probs,
                               atol=ATOL, rtol=0)
    tm, _ = tnn.dynamic_decode(tdec, tinits, max_step_num=STEPS,
                               output_time_major=True)
    jm, _ = jnn.dynamic_decode(jdec, jinits, max_step_num=STEPS,
                               output_time_major=True)
    np.testing.assert_array_equal(tm.numpy(), jm.numpy())
    np.testing.assert_array_equal(tm.numpy(), tout.numpy().swapaxes(0, 1))
    return got


@pytest.mark.parametrize("end_bias", [1.2, 1.6])
def test_transformer_beam_search_matches_reference(end_bias):
    ref, port = pair()
    for m in (ref, port):
        m.eval()
    ref.head.bias._data = ref.head.bias._data.at[END].set(end_bias)
    with torch.no_grad():
        port.head.bias[END] = end_bias
    src, _, _, bias = batch(0)
    jsrc, jbias = paddle.to_tensor(src), paddle.to_tensor(bias)
    tsrc, tbias = torch.from_numpy(src), torch.from_numpy(bias)
    jmem = ref.transformer.encoder(ref.embed(ref.src_emb, ref.src_pos, jsrc),
                                   jbias)
    with torch.no_grad():
        tmem = port.transformer.encoder(
            port.embed(port.src_emb, port.src_pos, tsrc), tbias)
        np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem._data),
                                   atol=ATOL, rtol=0)
        jdec = jnn.BeamSearchDecoder(j_cell(ref, jmem, jbias, BEAM), START,
                                     END, BEAM, embedding_fn=ref.tgt_emb,
                                     output_fn=ref.head)
        tdec = tnn.BeamSearchDecoder(t_cell(port, tmem, tbias, BEAM), START,
                                     END, BEAM, embedding_fn=port.tgt_emb,
                                     output_fn=port.head)
        zeros = np.zeros(src.shape[0], np.int64)
        got = _compare_decodes(
            jdec, tdec,
            (ref.transformer.decoder.gen_cache(jmem),
             paddle.to_tensor(zeros)),
            (port.transformer.decoder.gen_cache(tmem),
             torch.from_numpy(zeros)))
    finished = got[-1][3]
    if end_bias == 1.2:          # some beams end, others run to the limit
        assert len(got) == STEPS and finished.any() and not finished.all()
    else:                        # every beam ends before the limit
        assert len(got) < STEPS and finished.all()


@pytest.mark.parametrize("end_bias", [0.0, 0.25])
def test_lstm_cell_beam_search_matches_reference(end_bias):
    V, E, H, B = 40, 8, 16, 2
    jparts = (jnn.Embedding(V, E), jnn.LSTMCell(E, H), jnn.Linear(H, V))
    tparts = (tnn.Embedding(V, E, device="cpu"),
              tnn.LSTMCell(E, H, device="cpu"),
              tnn.Linear(H, V, device="cpu"))
    for j, t in zip(jparts, tparts):
        load_named_params(t, named(j))
    jparts[2].bias._data = jparts[2].bias._data.at[END].set(end_bias)
    with torch.no_grad():
        tparts[2].bias[END] = end_bias
    rng = np.random.default_rng(4)
    h0, c0 = (rng.standard_normal((B, H)).astype(np.float32)
              for _ in range(2))
    jdec = jnn.BeamSearchDecoder(jparts[1], START, END, BEAM,
                                 embedding_fn=jparts[0], output_fn=jparts[2])
    tdec = tnn.BeamSearchDecoder(tparts[1], START, END, BEAM,
                                 embedding_fn=tparts[0], output_fn=tparts[2])
    with torch.no_grad():
        _compare_decodes(jdec, tdec,
                         (paddle.to_tensor(h0), paddle.to_tensor(c0)),
                         (torch.from_numpy(h0), torch.from_numpy(c0)))


def test_states_in_dicts_lists_and_namedtuples_follow_the_beams():
    """Every tensor leaf of the cell's states is tiled, then reordered by
    the chosen parents; other leaves pass through."""
    V, B = 5, 2
    seen = []

    def cell(inputs, states):
        seen.append(states)
        logits = torch.zeros(inputs.shape[0], V)
        logits[torch.arange(inputs.shape[0]), (inputs + 1) % V] = 1.0
        return logits, states

    inits = {"a": [torch.tensor([[1.0], [2.0]])],
             "c": tnn.MultiHeadAttention.Cache(torch.zeros(B, 0, 1, 1),
                                               torch.ones(B, 3)),
             "tag": "kept"}
    dec = tnn.BeamSearchDecoder(cell, 0, V - 1, 2)
    tnn.dynamic_decode(dec, inits, max_step_num=2)
    first = seen[0]
    assert first["tag"] == "kept"
    assert isinstance(first["c"], tnn.MultiHeadAttention.Cache)
    np.testing.assert_array_equal(first["a"][0].numpy().ravel(),
                                  [1, 1, 2, 2])
    assert tuple(first["c"].k.shape) == (2 * B, 0, 1, 1)
    with pytest.raises(ValueError, match="no tensor"):
        dec.initialize({"tag": "none"})


class _CounterCell:
    """tests/test_decode_nce.py's deterministic 'cell': logits favor
    (last_token + 1) % V, so the best beam is the counting sequence."""

    def __init__(self, vocab, hidden=4):
        self.vocab = vocab

    def __call__(self, inputs, states):
        ids = inputs.long().reshape(-1)
        logits = torch.full((ids.numel(), self.vocab), -5.0)
        rows = torch.arange(ids.numel())
        logits[rows, (ids + 1) % self.vocab] = 5.0
        logits[rows, ids] = 2.0              # second best: the same token
        return logits, states


def test_counting_sequence_wins():
    V, B, W = 7, 2, 3
    end = V - 1
    dec = tnn.BeamSearchDecoder(_CounterCell(V), start_token=0,
                                end_token=end, beam_size=W)
    out, state, lengths = tnn.dynamic_decode(dec, torch.zeros(B, 4),
                                             max_step_num=10,
                                             return_length=True)
    pred = out.numpy()                       # [B, T, W]
    assert pred.shape[0] == B and pred.shape[2] == W
    np.testing.assert_array_equal(pred[0, :end, 0], np.arange(1, end + 1))
    assert (pred[0, end:, 0] == end).all()
    assert lengths.numpy()[0, 0] == end


def test_finished_beams_freeze():
    V, end = 4, 3
    dec = tnn.BeamSearchDecoder(_CounterCell(V), start_token=0,
                                end_token=end, beam_size=2)
    out, state = tnn.dynamic_decode(dec, torch.zeros(1, 4), max_step_num=8)
    pred = out.numpy()[0, :, 0]
    first_end = int(np.argmax(pred == end))
    assert (pred[first_end:] == end).all()
