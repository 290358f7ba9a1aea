"""Recurrent layers (port of paddle_tpu/nn/layer/rnn.py): the cells
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell`` and the sequence layers
``RNN``, ``BiRNN``, ``SimpleRNN``, ``LSTM``, ``GRU``.

Gates are ordered as in the reference (LSTM i, f, g, o; GRU r, z, c) and
every weight and bias starts uniform in ±1/sqrt(hidden_size) (``:36-53``);
parameter names are the reference's (``weight_ih``, ``weight_hh_l0``,
``bias_hh_l1_reverse``, ...), so weights carry across with
models/convert.py ``load_named_params``.  The loop over time is a Python
loop over PyTorch ops; the multi-layer layers project the input of every
step in one product before it, as the reference's scan does
(``:206-216``).  Layers are created on the card unless ``device="cpu"`` is
asked for.

Under ``amp.auto_cast`` each cell call is one op, cast by the reference's
names ``simple_rnn_cell``, ``lstm_cell`` and ``gru_cell`` (its inputs,
states, weights and biases), and each multi-layer call one op named by the
layer's mode, ``RNN_TANH``, ``RNN_RELU``, ``LSTM`` or ``GRU`` (its inputs,
every weight and bias, the initial states); none of these names is on a
list, so O2 casts them to the AMP dtype and O1 leaves them unless a custom
list names them.

Where the reference ignores an argument, the port does what PaddlePaddle
documents for it:
- ``sequence_length`` ((B,) ints): a sequence's state stops changing after
  its last step and its outputs there are 0; a reverse direction starts
  at each sequence's last step;
- ``time_major`` on ``SimpleRNN`` / ``LSTM`` / ``GRU``: (T, B, F) in and
  out (the reference scans the batch axis there);
- ``dropout``: applied to the output of every layer but the last in
  training mode, drawn from ``generator``.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.amp import _op_scope, amp_cast_for_op
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.initializer import Uniform
from paddle_tpu_torch.nn.layer.common import make_param
from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]

_GATES = {"RNN_TANH": 1, "RNN_RELU": 1, "LSTM": 4, "GRU": 3}
_ACTIVATIONS = {"tanh": "RNN_TANH", "relu": "RNN_RELU"}


def _add_params(module, suffix, input_size, hidden_size, gates, device,
                weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr):
    """Register weight_ih, weight_hh, bias_ih, bias_hh (+ ``suffix``),
    uniform in ±1/sqrt(hidden_size) unless an attr says otherwise; a bias
    whose attr is False is None."""
    if weight_ih_attr is False or weight_hh_attr is False:
        raise ValueError("a recurrent cell needs its weights")
    std = 1.0 / math.sqrt(hidden_size)
    init = Uniform(-std, std)
    rows = gates * hidden_size
    for name, shape, attr, is_bias in (
            ("weight_ih", [rows, input_size], weight_ih_attr, False),
            ("weight_hh", [rows, hidden_size], weight_hh_attr, False),
            ("bias_ih", [rows], bias_ih_attr, True),
            ("bias_hh", [rows], bias_hh_attr, True)):
        module.register_parameter(name + suffix, make_param(
            shape, attr, init, is_bias=is_bias, device=device))


def _project(x, w, b):
    out = x @ w.T
    return out if b is None else out + b


def _recur(mode, gi, state, w_hh, b_hh):
    """One step from the input's projection gi = x W_ih^T + b_ih and the
    state (h, or (h, c) for the LSTM): (output, new state)."""
    h = state[0] if mode == "LSTM" else state
    gh = _project(h, w_hh, b_hh)
    if mode == "LSTM":
        i, f, g, o = (gi + gh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * state[1] + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)
    if mode == "GRU":
        ir, iz, ic = gi.chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        h = (1 - z) * c + z * h
        return h, h
    h = (torch.tanh if mode == "RNN_TANH" else torch.relu)(gi + gh)
    return h, h


def _scan(step, xs, state, sequence_length, reverse):
    """Run ``step(x_t, state) -> (out, state)`` over the time-major xs (T,
    B, ...), last step first when ``reverse``.  With ``sequence_length``
    the state holds and the output is 0 from each sequence's length on.
    Returns the (T, B, ...) outputs and the final state."""
    steps = xs.shape[0]
    live = None
    if sequence_length is not None:
        lens = torch.as_tensor(sequence_length, device=xs.device)
        live = (torch.arange(steps, device=xs.device)[:, None]
                < lens[None, :])[..., None]                  # (T, B, 1)
    outs = [None] * steps
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        out, new = step(xs[t], state)
        if live is not None:
            if isinstance(new, tuple):
                new = tuple(torch.where(live[t], n, s)
                            for n, s in zip(new, state))
            else:
                new = torch.where(live[t], new, state)
            out = torch.where(live[t], out, 0.0)
        state = new
        outs[t] = out
    return torch.stack(outs), state


class RNNCellBase(Layer):
    """A cell's initial states (reference ``:24``)."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``shape`` (the cell's ``state_shape`` by default)
        behind the batch size of ``batch_ref`` along ``batch_dim_idx``,
        filled with ``init_value``, on its device, in ``dtype`` (by default
        batch_ref's floating dtype, else float32)."""
        b = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        if dtype is None:
            dtype = (batch_ref.dtype if batch_ref.is_floating_point()
                     else torch.float32)

        def full(s):
            return torch.full([b] + list(s), init_value, dtype=dtype,
                              device=batch_ref.device)
        if isinstance(shape[0], (list, tuple)):
            return tuple(full(s) for s in shape)
        return full(shape)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        flat = list(states) if isinstance(states, tuple) else [states]
        x, *cast = amp_cast_for_op(self.OP, [
            inputs, *flat, self.weight_ih, self.weight_hh, self.bias_ih,
            self.bias_hh])
        n = len(flat)
        w_ih, w_hh, b_ih, b_hh = cast[n:]
        with _op_scope():
            return _recur(self.mode, _project(x, w_ih, b_ih),
                          tuple(cast[:n]) if n > 1 else cast[0], w_hh, b_hh)


class SimpleRNNCell(RNNCellBase):
    """h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh), act tanh or relu
    (reference ``:55``)."""

    OP = "simple_rnn_cell"

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be 'tanh' or 'relu', got "
                             f"{activation!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self.mode = _ACTIVATIONS[activation]
        _add_params(self, "", input_size, hidden_size, 1,
                    resolve_device(device), weight_ih_attr, weight_hh_attr,
                    bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    """The LSTM step, gates i, f, g, o; states (h, c) (reference
    ``:92``)."""

    OP = "lstm_cell"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.mode = "LSTM"
        _add_params(self, "", input_size, hidden_size, 4,
                    resolve_device(device), weight_ih_attr, weight_hh_attr,
                    bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    """The GRU step, gates r, z, c, h' = (1 - z) c + z h (reference
    ``:132``)."""

    OP = "gru_cell"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.mode = "GRU"
        _add_params(self, "", input_size, hidden_size, 3,
                    resolve_device(device), weight_ih_attr, weight_hh_attr,
                    bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """A cell run over time, last step first when ``is_reverse``
    (reference ``:175``).  Returns (outputs, final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        if initial_states is None:
            initial_states = self.cell.get_initial_states(xs,
                                                          batch_dim_idx=1)
        out, states = _scan(self.cell, xs, initial_states, sequence_length,
                            self.is_reverse)
        return (out if self.time_major else out.transpose(0, 1)), states


class BiRNN(Layer):
    """A forward and a reverse ``RNN``, outputs concatenated on the last
    axis, states (forward's, reverse's) (reference ``:202``)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = ((None, None) if initial_states is None
                      else initial_states)
        out_fw, st_fw = self.rnn_fw(inputs, s_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, s_bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    """``num_layers`` recurrent layers, one or two directions each
    (reference ``:218``).  States are (num_layers * directions, B, H),
    (h, c) for the LSTM; zeros when not given."""

    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None, generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction must be 'forward' or 'bidirect', "
                             f"got {direction!r}")
        self.mode = self.MODE
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.generator = generator
        self.bidirectional = direction != "forward"
        self._num_dirs = 2 if self.bidirectional else 1
        dev = resolve_device(device)
        for layer in range(num_layers):
            for d in range(self._num_dirs):
                in_size = (input_size if layer == 0
                           else hidden_size * self._num_dirs)
                _add_params(self, self._suffix(layer, d), in_size,
                            hidden_size, _GATES[self.MODE], dev,
                            weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr)

    @staticmethod
    def _suffix(layer, d):
        return f"_l{layer}" + ("_reverse" if d else "")

    def forward(self, inputs, initial_states=None, sequence_length=None):
        lstm = self.mode == "LSTM"
        names = [n + self._suffix(layer, d) for layer in range(self.num_layers)
                 for d in range(self._num_dirs)
                 for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        states = ([] if initial_states is None else
                  list(initial_states) if lstm else [initial_states])
        cast = amp_cast_for_op(self.mode, [inputs] + [
            getattr(self, n) for n in names] + states)
        with _op_scope():
            return self._run(cast[0], dict(zip(names, cast[1:len(names) + 1])),
                             cast[len(names) + 1:], sequence_length)

    def _run(self, inputs, params, states, sequence_length):
        lstm = self.mode == "LSTM"
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        if not states:
            zero = xs.new_zeros(self.num_layers * self._num_dirs,
                                xs.shape[1], self.hidden_size)
            h0, c0 = zero, zero
        else:
            h0, c0 = states if lstm else (states[0], None)
        out, h_n, c_n = xs, [], []
        for layer in range(self.num_layers):
            if layer > 0:
                out = F.dropout(out, p=self.dropout, training=self.training,
                                generator=self.generator)
            outs = []
            for d in range(self._num_dirs):
                k, sfx = layer * self._num_dirs + d, self._suffix(layer, d)
                w_hh = params["weight_hh" + sfx]
                b_hh = params["bias_hh" + sfx]
                gi = _project(out, params["weight_ih" + sfx],
                              params["bias_ih" + sfx])

                def step(g, s, w_hh=w_hh, b_hh=b_hh):
                    return _recur(self.mode, g, s, w_hh, b_hh)
                ys, st = _scan(step, gi, (h0[k], c0[k]) if lstm else h0[k],
                               sequence_length, reverse=d == 1)
                outs.append(ys)
                h_n.append(st[0] if lstm else st)
                if lstm:
                    c_n.append(st[1])
            out = torch.cat(outs, dim=-1) if len(outs) == 2 else outs[0]
        out = out if self.time_major else out.transpose(0, 1)
        h = torch.stack(h_n)
        return out, ((h, torch.stack(c_n)) if lstm else h)


class SimpleRNN(_RNNBase):
    """Elman RNN layers, tanh or relu (reference ``:380``)."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be 'tanh' or 'relu', got "
                             f"{activation!r}")
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)
        self.mode = _ACTIVATIONS[activation]


class LSTM(_RNNBase):
    """LSTM layers (reference ``:391``)."""
    MODE = "LSTM"


class GRU(_RNNBase):
    """GRU layers (reference ``:395``)."""
    MODE = "GRU"
