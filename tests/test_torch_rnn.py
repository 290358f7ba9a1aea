"""The port's recurrent layers against the reference on the CPU: the three
cells, ``RNN``, ``BiRNN`` and ``SimpleRNN`` / ``LSTM`` / ``GRU`` with 1
and 2 layers, forward and bidirect, ``time_major`` on and off, with and
without ``sequence_length``, the initial states given and not given.
Weights carry by name (``load_named_params``).  Outputs and final states
1e-5, gradients (every parameter's and the input's, of a weighted sum of
outputs and states) 1e-4, absolute, f32.

Where the reference ignores an argument the port follows PaddlePaddle's
documented meaning, and the test shows the reference's behaviour first:
- ``sequence_length``: the reference ignores it; the port is held to the
  reference run on each sequence cut to its length, its outputs past the
  length zero;
- ``time_major`` on the multi-layer layers: the reference scans the batch
  axis; the port is held to the reference on the batch-major transpose;
- ``dropout`` between layers: the reference ignores it; the port is held
  to single-layer reference layers with the port's keep mask between.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch.models import load_named_params

ATOL = 1e-5
ATOL_GRAD = 1e-4
B, T, IN, H = 3, 7, 5, 6
LENS = np.array([T, 4, T])          # one sequence cut short


def _named(layer):
    return {n: np.array(p._data) for n, p in layer.named_parameters()}


def _rng(seed):
    return np.random.default_rng(seed)


def _flat(states):
    """A state tree (tensor, or tuples of them) as a list of leaves."""
    if isinstance(states, (tuple, list)):
        return [x for s in states for x in _flat(s)]
    return [states]


def _ref_run(layer, x, init=None, **kw):
    """Reference forward and backward of sum(out * w) + sum(state * v):
    (out, states, {param: grad}, dx) as numpy."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    args = [jx] if init is None else [jx, _map(paddle.to_tensor, init)]
    out, st = layer(*args, **kw)
    loss = _weighted(out, st, lambda a: paddle.to_tensor(a))
    loss.backward()
    return (np.asarray(out._data), [np.asarray(s._data) for s in _flat(st)],
            {n: np.asarray(p.grad._data) for n, p in layer.named_parameters()},
            np.asarray(jx.grad._data))


def _port_run(layer, x, init=None, time_major=False, **kw):
    """As _ref_run for the port; with ``time_major`` x and the output are
    (T, B, ...), weighted as their batch-major transposes."""
    tx = torch.from_numpy(x).requires_grad_()
    args = [tx] if init is None else [tx, _map(torch.from_numpy, init)]
    out, st = layer(*args, **kw)
    _weighted(out.transpose(0, 1) if time_major else out, st,
              torch.from_numpy).backward()
    return (out.detach().numpy(), [s.detach().numpy() for s in _flat(st)],
            {n: p.grad.numpy() for n, p in layer.named_parameters()},
            tx.grad.numpy())


def _map(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_map(fn, t) for t in tree)
    return fn(tree)


def _weighted(out, states, wrap):
    rng = _rng(99)
    loss = (out * wrap(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))).sum()
    for s in _flat(states):
        loss = loss + (s * wrap(rng.standard_normal(tuple(s.shape)).astype(
            np.float32))).sum()
    return loss


def _compare(want, got):
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    assert set(got[2]) == set(want[2])
    for n in want[2]:
        np.testing.assert_allclose(got[2][n], want[2][n], atol=ATOL_GRAD,
                                   rtol=0, err_msg=n)
    np.testing.assert_allclose(got[3], want[3], atol=ATOL_GRAD, rtol=0)


def _cell_pair(kind):
    if kind.startswith("simple"):
        act = kind.split("_")[1]
        ref = jnn.SimpleRNNCell(IN, H, activation=act)
        port = tnn.SimpleRNNCell(IN, H, activation=act, device="cpu")
    else:
        ref = getattr(jnn, kind)(IN, H)
        port = getattr(tnn, kind)(IN, H, device="cpu")
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    return ref, load_named_params(port, _named(ref))


def _states(kind, seed, batch=B, lead=()):
    rng = _rng(seed)

    def one():
        return rng.standard_normal(lead + (batch, H)).astype(np.float32)
    return (one(), one()) if "LSTM" in kind else one()


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("kind", ["simple_tanh", "simple_relu", "LSTMCell",
                                  "GRUCell"])
def test_cells_match_reference(kind, given):
    ref, port = _cell_pair(kind)
    x = _rng(1).standard_normal((B, IN)).astype(np.float32)
    init = _states(kind, 2) if given else None
    _compare(_ref_run(ref, x, init), _port_run(port, x, init))


def test_initial_states():
    cell = tnn.LSTMCell(IN, H, device="cpu")
    h, c = cell.get_initial_states(torch.zeros(4, 2, IN), batch_dim_idx=1,
                                   init_value=0.5)
    assert h.shape == (2, H) and c.shape == (2, H)
    assert bool((h == 0.5).all()) and h.dtype == torch.float32
    s = tnn.GRUCell(IN, H, device="cpu").get_initial_states(
        torch.zeros(3, IN, dtype=torch.bfloat16))
    assert s.shape == (3, H) and s.dtype == torch.bfloat16


def _truncated_ref(ref, x, lens, time_major, init=None, pick=None):
    """The reference run on each sequence cut to its length, padded back
    with zero outputs: (out, final states) as numpy.  ``pick(init, b)``
    takes sample b's initial states."""
    outs, states = [], []
    for b, n in enumerate(lens):
        xb = x[:n, b:b + 1] if time_major else x[b:b + 1, :n]
        args = [paddle.to_tensor(xb)]
        if init is not None:
            args.append(_map(paddle.to_tensor, pick(init, b)))
        o, st = ref(*args)
        o = np.asarray(o._data)
        pad = [(0, 0)] * o.ndim
        pad[0 if time_major else 1] = (0, x.shape[0 if time_major else 1]
                                       - n)
        outs.append(np.pad(o, pad))
        states.append([np.asarray(s._data) for s in _flat(st)])
    out = np.concatenate(outs, axis=1 if time_major else 0)
    return out, [np.concatenate([s[i] for s in states], axis=-2)
                 for i in range(len(states[0]))]


def _wrapper_pair(bi, kind):
    if bi:
        ref = jnn.BiRNN(getattr(jnn, kind)(IN, H), getattr(jnn, kind)(IN, H),
                        time_major=False)
        port = tnn.BiRNN(getattr(tnn, kind)(IN, H, device="cpu"),
                         getattr(tnn, kind)(IN, H, device="cpu"))
    else:
        ref = jnn.RNN(getattr(jnn, kind)(IN, H))
        port = tnn.RNN(getattr(tnn, kind)(IN, H, device="cpu"))
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    return ref, load_named_params(port, _named(ref))


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("kind", ["LSTMCell", "GRUCell"])
@pytest.mark.parametrize("wrapper", ["RNN", "RNN_reverse", "BiRNN"])
def test_rnn_wrappers_match_reference(wrapper, kind, given, time_major):
    bi = wrapper == "BiRNN"
    ref, port = _wrapper_pair(bi, kind)
    if wrapper == "RNN_reverse":
        ref.is_reverse = port.is_reverse = True
    ref.time_major = port.time_major = time_major
    if bi:
        for r in (ref.rnn_fw, ref.rnn_bw, port.rnn_fw, port.rnn_bw):
            r.time_major = time_major
    x = _rng(3).standard_normal((B, T, IN)).astype(np.float32)
    if time_major:
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    init = None
    if given:
        init = ((_states(kind, 4), _states(kind, 5)) if bi
                else _states(kind, 4))
    _compare(_ref_run(ref, x, init), _port_run(port, x, init))
    # sequence_length: the reference ignores it (its output is the
    # unmasked one); the port matches each sequence run to its length
    ignored = ref(paddle.to_tensor(x), sequence_length=paddle.to_tensor(
        LENS))[0]
    np.testing.assert_array_equal(np.asarray(ignored._data),
                                  np.asarray(ref(paddle.to_tensor(x))[0]
                                             ._data))

    def pick(st, b):
        return _map(lambda a: a[b:b + 1], st)
    want_out, want_st = _truncated_ref(ref, x, LENS, time_major, init, pick)
    tinit = None if init is None else _map(torch.from_numpy, init)
    got_out, got_st = port(torch.from_numpy(x), tinit,
                           sequence_length=torch.from_numpy(LENS))
    np.testing.assert_allclose(got_out.detach().numpy(), want_out, atol=ATOL,
                               rtol=0)
    for a, b in zip(_flat(got_st), want_st):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=ATOL, rtol=0)


LAYERS = [("SimpleRNN", 1, "forward"), ("SimpleRNN", 2, "bidirect"),
          ("LSTM", 1, "forward"), ("LSTM", 2, "bidirect"),
          ("LSTM", 1, "bidirect"), ("LSTM", 2, "forward"),
          ("GRU", 1, "forward"), ("GRU", 2, "bidirect")]


def _layer_pair(kind, layers, direction, dropout=0.0):
    ref = getattr(jnn, kind)(IN, H, layers, direction=direction)
    port = getattr(tnn, kind)(IN, H, layers, direction=direction,
                              dropout=dropout, device="cpu")
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    return ref, load_named_params(port, _named(ref))


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("kind,layers,direction", LAYERS)
def test_rnn_layers_match_reference(kind, layers, direction, given):
    ref, port = _layer_pair(kind, layers, direction)
    dirs = 2 if direction == "bidirect" else 1
    x = _rng(6).standard_normal((B, T, IN)).astype(np.float32)
    init = _states(kind, 7, lead=(layers * dirs,)) if given else None
    want = _ref_run(ref, x, init)
    _compare(want, _port_run(port, x, init))
    # time_major: (T, B, F) in and out, the same numbers transposed
    port.zero_grad()
    xt = np.ascontiguousarray(x.transpose(1, 0, 2))
    port.time_major = True
    got = _port_run(port, xt, init, time_major=True)
    _compare((want[0].transpose(1, 0, 2), want[1], want[2],
              want[3].transpose(1, 0, 2)), got)
    port.time_major = False

    def pick(st, b):
        return _map(lambda a: a[:, b:b + 1], st)
    want_out, want_st = _truncated_ref(ref, x, LENS, False, init, pick)
    tinit = None if init is None else _map(torch.from_numpy, init)
    for tm in (False, True):
        port.time_major = tm
        xin = torch.from_numpy(xt if tm else x)
        out, st = port(xin, tinit, sequence_length=torch.from_numpy(LENS))
        out = out.detach().numpy()
        np.testing.assert_allclose(out.transpose(1, 0, 2) if tm else out,
                                   want_out, atol=ATOL, rtol=0)
        for a, b in zip(_flat(st), want_st):
            np.testing.assert_allclose(a.detach().numpy(), b, atol=ATOL,
                                       rtol=0)


def test_reference_ignores_sequence_length_time_major_and_dropout():
    """What the port does not copy: the reference's multi-layer layers
    ignore sequence_length and dropout, and with time_major scan the batch
    axis (a (T, B, F) input comes back (B, T, H))."""
    ref = jnn.LSTM(IN, H, 2, direction="bidirect", dropout=0.5)
    x = _rng(8).standard_normal((B, T, IN)).astype(np.float32)
    plain = np.asarray(ref(paddle.to_tensor(x))[0]._data)
    masked = ref(paddle.to_tensor(x),
                 sequence_length=paddle.to_tensor(LENS))[0]
    np.testing.assert_array_equal(np.asarray(masked._data), plain)
    ref.train()
    np.testing.assert_array_equal(
        np.asarray(ref(paddle.to_tensor(x))[0]._data), plain)
    ref.time_major = True
    out = ref(paddle.to_tensor(np.ascontiguousarray(x.transpose(1, 0, 2))))
    assert tuple(out[0].shape) == (B, T, 2 * H)


def test_dropout_between_layers():
    """Training-mode dropout on the first layer's output, drawn from the
    layer's generator: the port equals two single-layer reference LSTMs
    with the same keep mask between them; eval mode and dropout 0 are the
    stack without it."""
    ref, port = _layer_pair("LSTM", 2, "bidirect", dropout=0.5)
    named = _named(ref)
    low = jnn.LSTM(IN, H, 1, direction="bidirect")
    high = jnn.LSTM(2 * H, H, 1, direction="bidirect")
    for layer, src in ((low, "l0"), (high, "l1")):
        for n, p in layer.named_parameters():
            p._data = paddle.to_tensor(named[n.replace("l0", src)])._data
    x = _rng(9).standard_normal((B, T, IN)).astype(np.float32)
    port.generator = torch.Generator().manual_seed(5)
    port.train()
    got, (h, c) = port(torch.from_numpy(x))
    keep = tF.dropout(torch.ones(T, B, 2 * H), p=0.5,
                      generator=torch.Generator().manual_seed(5))
    mid, (h0, c0) = low(paddle.to_tensor(x))
    mid = np.asarray(mid._data) * keep.numpy().transpose(1, 0, 2)
    want, (h1, c1) = high(paddle.to_tensor(mid.astype(np.float32)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        h.detach().numpy(), np.concatenate([np.asarray(h0._data),
                                            np.asarray(h1._data)]),
        atol=ATOL, rtol=0)
    port.eval()
    np.testing.assert_allclose(port(torch.from_numpy(x))[0].detach().numpy(),
                               np.asarray(ref(paddle.to_tensor(x))[0]._data),
                               atol=ATOL, rtol=0)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="direction"):
        tnn.GRU(IN, H, direction="sideways", device="cpu")
    with pytest.raises(ValueError, match="activation"):
        tnn.SimpleRNN(IN, H, activation="gelu", device="cpu")
    with pytest.raises(TypeError, match="ParamAttr"):
        tnn.LSTMCell(IN, H, weight_ih_attr=object(), device="cpu")
    cell = tnn.GRUCell(IN, H, bias_ih_attr=False, bias_hh_attr=False,
                       device="cpu")
    assert [n for n, _ in cell.named_parameters()] == ["weight_ih",
                                                       "weight_hh"]
    out, h = cell(torch.zeros(2, IN))
    assert out.shape == (2, H) and torch.equal(out, h)


# -- AMP ----------------------------------------------------------------------

TOL_BF16 = 2e-2
CELL_OPS = {"simple_tanh": "simple_rnn_cell", "LSTMCell": "lstm_cell",
            "GRUCell": "gru_cell"}


def _bf16_close(got, want, what):
    """max |got - want| / (|want| + rms(want)) <= 2e-2, the bf16 measure
    of test_torch_vision_functional.py."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want) + np.sqrt(np.mean(np.square(want)))
    err = float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))
    assert err <= TOL_BF16, f"{what}: bf16 error {err:.3g}"


def _leaves(tree):
    return [np.asarray(t._data if hasattr(t, "_data") else
                       t.detach().float(), np.float32) for t in _flat(tree)]


@pytest.mark.parametrize("kind", list(CELL_OPS))
def test_cells_under_auto_cast_o1_custom_white_list(kind):
    """O1 leaves a cell as it comes; naming its op in custom_white_list
    casts its inputs, states, weights and biases to bf16, in both."""
    import paddle_tpu.amp as jamp
    import paddle_tpu_torch.amp as tamp
    op = CELL_OPS[kind]
    ref, port = _cell_pair(kind)
    x = _rng(1).standard_normal((B, IN)).astype(np.float32)
    for white in (None, {op}):
        with jamp.auto_cast(custom_white_list=white):
            want = ref(paddle.to_tensor(x))
        with tamp.auto_cast(custom_white_list=white), \
                tamp.trace_ops() as trace:
            got = port(torch.from_numpy(x))
        dt = torch.bfloat16 if white else torch.float32
        n = 7 if kind == "LSTMCell" else 6
        assert trace == [(op, [dt] * n)]
        for g, w in zip(_leaves(got), _leaves(want)):
            if white:
                _bf16_close(g, w, op)
            else:
                np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        assert all(t.dtype == dt for t in _flat(got))


@pytest.mark.parametrize("kind,mode", [("SimpleRNN", "RNN_TANH"),
                                       ("LSTM", "LSTM"), ("GRU", "GRU")])
def test_layers_under_auto_cast_o2(kind, mode):
    """O2 casts a layer's call, op ``mode``, to bf16: the port's f32 layer
    on an f32 input against the reference decorated to bf16 on the same
    input in bf16 (the reference's O2 cannot take an f32 tensor); O1 with
    the mode in custom_white_list casts the same way."""
    import jax.numpy as jnp

    import paddle_tpu.amp as jamp
    import paddle_tpu_torch.amp as tamp
    ref = getattr(jnn, kind)(IN, H, num_layers=2, direction="bidirect")
    port = load_named_params(getattr(tnn, kind)(
        IN, H, num_layers=2, direction="bidirect", device="cpu"),
        _named(ref))
    x = _rng(3).standard_normal((B, T, IN)).astype(np.float32)
    jamp.decorate(ref, level="O2")
    with jamp.auto_cast(level="O2"):
        want = ref(paddle.to_tensor(jnp.asarray(x, jnp.bfloat16)))
    for level, white in (("O2", None), ("O1", {mode})):
        with tamp.auto_cast(level=level, custom_white_list=white), \
                tamp.trace_ops() as trace:
            got = port(torch.from_numpy(x))
        assert trace == [(mode, [torch.bfloat16] * 17)]
        for g, w in zip(_leaves(got), _leaves(want)):
            _bf16_close(g, w, f"{kind} {level}")
