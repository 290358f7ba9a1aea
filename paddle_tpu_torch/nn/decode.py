"""Sequence decoding: ``Decoder``, ``BeamSearchDecoder``, ``dynamic_decode``
and ``gather_tree`` (port of paddle_tpu/nn/decode.py).

The beam bookkeeping stays on the device of the cell's logits as torch
ops, and chooses what the reference chooses: the f32 log-softmax of the
logits; a finished beam extends only by ``end_token``, at zero cost; the
W best of the flattened (B, W * V) scores, ordered by score; parent
``top // V`` and token ``top % V``; a beam's length counts the steps
before it finished.  The reference orders its winners with an unstable
``np.argsort``, the port with ``torch.topk``: exact ties may come out in
another order.  ``dynamic_decode`` reads one bool from the device a step,
to end the loop once every beam has finished, as the reference does.

States are beam-major (B * W, ...).  The cell's states may nest tensors in
tuples, lists, dicts and namedtuples (the attention ``Cache`` and
``StaticCache``); every tensor leaf is tiled and reordered along axis 0.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree"]


class Decoder:
    """The decoding contract (reference ``:26``): initialize, step,
    finalize."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class _BeamState(NamedTuple):
    cell_states: object          # tensors of (B * W, ...), nested
    log_probs: torch.Tensor      # (B, W) f32
    finished: torch.Tensor       # (B, W) bool
    lengths: torch.Tensor        # (B, W) int64


def _map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to every tensor leaf; tuples, lists,
    dicts and namedtuples are rebuilt, any other leaf kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return tree


def gather_tree(ids, parents):
    """Backtrace (T, B, W) step ids and parent-beam indices into the final
    sequences (reference ``:50``, the gather_tree op): from the last step
    back, each beam takes its token and moves to its parent.  Takes
    tensors or arrays; returns a tensor on the ids' device."""
    ids, parents = torch.as_tensor(ids), torch.as_tensor(parents)
    parents = parents.to(ids.device)
    T, B, W = ids.shape
    out = torch.empty_like(ids)
    beam = torch.arange(W, device=ids.device).expand(B, W)
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(1, beam)
        beam = parents[t].long().gather(1, beam)
    return out


class BeamSearchDecoder(Decoder):
    """Beam search over ``cell(inputs, states) -> (out, new_states)``
    (reference ``:67``); ``embedding_fn`` maps ids to the cell's inputs,
    ``output_fn`` the cell's output to (B * W, V) logits."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn or (lambda ids: ids)
        self.output_fn = output_fn or (lambda x: x)

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """(B, ...) -> (B * beam_size, ...), each row repeated beam_size
        times in place (reference ``:84``): for tensors the cell closes
        over, such as the attention memory and its mask."""
        return torch.as_tensor(x).repeat_interleave(beam_size, dim=0)

    def initialize(self, initial_cell_states):
        leaves = []
        _map_tensors(leaves.append, initial_cell_states)
        if not leaves:
            raise ValueError("BeamSearchDecoder: the initial cell states "
                             "hold no tensor to take the batch size from")
        batch, dev, W = int(leaves[0].shape[0]), leaves[0].device, \
            self.beam_size
        states = _map_tensors(
            lambda t: self.tile_beam_merge_with_batch(t, W),
            initial_cell_states)
        ids = torch.full((batch * W,), self.start_token, dtype=torch.int64,
                         device=dev)
        log_probs = torch.full((batch, W), -1e9, dtype=torch.float32,
                               device=dev)
        log_probs[:, 0] = 0.0                # only beam 0 is live at t = 0
        return self.embedding_fn(ids), _BeamState(
            states, log_probs,
            torch.zeros(batch, W, dtype=torch.bool, device=dev),
            torch.zeros(batch, W, dtype=torch.int64, device=dev))

    def step(self, time, inputs, state: _BeamState):
        W = self.beam_size
        cell_out, next_cell_states = self.cell(inputs, state.cell_states)
        logits = self.output_fn(cell_out).float()
        BW, V = logits.shape
        B = BW // W
        step_lp = torch.log_softmax(logits, dim=-1).view(B, W, V)
        # a finished beam extends only by end_token, at zero cost
        noend = torch.full((V,), -1e9, dtype=torch.float32,
                           device=logits.device)
        noend[self.end_token] = 0.0
        step_lp = torch.where(state.finished[:, :, None], noend, step_lp)
        flat = (state.log_probs[:, :, None] + step_lp).view(B, W * V)
        new_lp, top = torch.topk(flat, W, dim=1)     # ordered by score
        parent, token = top // V, top % V
        fin_parent = state.finished.gather(1, parent)
        finished = fin_parent | (token == self.end_token)
        lengths = state.lengths.gather(1, parent) + (~fin_parent).long()
        rows = (parent + torch.arange(B, device=parent.device)[:, None] * W
                ).view(-1)
        next_cell_states = _map_tensors(lambda t: t.index_select(0, rows),
                                        next_cell_states)
        next_inputs = self.embedding_fn(token.view(-1))
        outputs = {"token": token, "parent": parent}
        return outputs, _BeamState(next_cell_states, new_lp, finished,
                                   lengths), next_inputs, finished

    def finalize(self, outputs, final_state: _BeamState, sequence_lengths):
        """(B, T, W) sequences backtraced from the steps' tokens and
        parents, and the final state."""
        ids = torch.stack([o["token"] for o in outputs])       # (T, B, W)
        parents = torch.stack([o["parent"] for o in outputs])
        return gather_tree(ids, parents).permute(1, 0, 2), final_state


def dynamic_decode(decoder: Decoder, inits=None, max_step_num: int = 100,
                   output_time_major: bool = False,
                   return_length: bool = False, **kwargs):
    """Run ``decoder`` from ``initialize(inits)`` until every sequence has
    finished or ``max_step_num`` steps (reference ``:168``).  Returns
    (outputs, final states), outputs (T, B, W) with ``output_time_major``,
    and the (B, W) lengths too with ``return_length``."""
    inputs, state = decoder.initialize(inits)
    outputs = []
    for t in range(max_step_num):
        out, state, inputs, finished = decoder.step(t, inputs, state)
        outputs.append(out)
        if bool(finished.all()):
            break
    final_out, final_state = decoder.finalize(outputs, state, state.lengths)
    if output_time_major:
        final_out = final_out.transpose(0, 1)
    if return_length:
        return final_out, final_state, state.lengths
    return final_out, final_state
