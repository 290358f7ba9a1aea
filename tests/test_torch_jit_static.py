"""``jit.to_static`` of the port against the reference's on the CPU, eager
and captured (``torch.export``), with weights carried by name
(``models.load_named_params``) or by ``GPT.load_jax_params``:

- a small MLP's forward and backward through the capture (f32, 1e-5),
  one capture per signature (a new shape, ``training``) and none on a
  repeat, as the reference's cache counts them; an eager optimizer step
  between two calls seen by the next; BatchNorm's running statistics
  written back; dropout fresh at each call without a new capture; a
  plain function;
- ``gpt_tiny`` (1 layer, 2 heads of 64, S=128) through ``gpt_loss`` with
  ``FLAGS_gpt_fused_ce`` off and on: the loss (1e-5) and every gradient
  (1e-4) to the reference's jitted ones, the graph holding the
  ``flash_fwd`` (and ``fused_ce_fwd``) custom ops;
- a learned-bias encoder layer's dbias to the reference's (1e-4), and
  bitwise the port's eager one;
- every case of ``tests/test_dy2static.py`` and the four ``static.nn``
  functions, eager and captured, to the reference's results.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import jit as jjit
from paddle_tpu import static as jstatic
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit.dy2static import convert_to_static as jconvert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_ce as jce
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit.dy2static import convert_to_static as tconvert
from paddle_tpu_torch.models import GPT, gpt_loss, gpt_tiny, load_named_params
from paddle_tpu_torch.optimizer import SGD

ATOL = 1e-5
ATOL_GRAD = 1e-4
TINY = dict(num_layers=1, hidden_size=128, num_heads=2, max_seq_len=128,
            remat=False)


@pytest.fixture(autouse=True)
def _cpu():
    prev_dev, prev_mesh = tdevice.get_device(), get_mesh()
    tdevice.set_device("cpu")
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfa._INTERPRET = jce._INTERPRET = True
    yield
    jfa._INTERPRET = jce._INTERPRET = False
    jflags.set_flags({"gpt_fused_ce": False})
    tflags.set_flags({"gpt_fused_ce": False})
    tdevice._default = prev_dev
    set_mesh(prev_mesh)


def _named(layer):
    return {n: np.array(p._data) for n, p in layer.named_parameters()}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t._data)


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 16)
        self.fc2 = tnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(TF.relu(self.fc1(x)))


def _pair(seed=0):
    paddle.seed(seed)
    ref = JNet()
    return ref, load_named_params(TNet(), _named(ref))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_forward_and_backward_through_the_capture():
    ref, port = _pair()
    eager = load_named_params(TNet(), _named(ref))
    jjit.to_static(ref)
    tjit.to_static(port)
    x = _x((4, 8))
    out_j = ref(paddle.to_tensor(x))
    out_j.sum().backward()
    out_t = port(torch.from_numpy(x))
    out_t.sum().backward()
    out_e = eager(torch.from_numpy(x))
    out_e.sum().backward()
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=ATOL, rtol=0)
    assert torch.equal(out_t, out_e)
    assert type(out_t.grad_fn).__name__ == "_CapturedBackward"
    for (n, pj), (_, pt), (_, pe) in zip(ref.named_parameters(),
                                         port.named_parameters(),
                                         eager.named_parameters()):
        np.testing.assert_allclose(pt.grad.numpy(), _np(pj.grad),
                                   atol=ATOL, rtol=0, err_msg=n)
        assert torch.equal(pt.grad, pe.grad), n


def test_gradient_reaches_a_tensor_argument():
    ref, port = _pair()
    jjit.to_static(ref)
    tjit.to_static(port)
    x = _x((3, 8), 2)
    jx = paddle.to_tensor(x, stop_gradient=False)
    (ref(jx) ** 2).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    (port(tx) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), atol=ATOL,
                               rtol=0)


def test_one_capture_per_signature():
    ref, port = _pair()
    jjit.to_static(ref)
    tjit.to_static(port)
    seen = []
    for shape, train in [((2, 8), True), ((2, 8), True), ((5, 8), True),
                         ((2, 8), False), ((5, 8), False), ((2, 8), True)]:
        ref.train() if train else ref.eval()
        port.train() if train else port.eval()
        x = _x(shape)
        ref(paddle.to_tensor(x))
        port(torch.from_numpy(x))
        seen.append((len(ref.forward._cache), port.forward.captures,
                     len(port.forward._cache)))
    assert [s[0] for s in seen] == [1, 1, 2, 3, 4, 4]
    assert all(a == b == c for a, b, c in seen), seen


def test_an_optimizer_step_is_seen_by_the_next_call():
    ref, port = _pair()
    jjit.to_static(ref)
    tjit.to_static(port)
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=ref.parameters())
    topt = SGD(learning_rate=0.1, parameters=port.parameters())
    x = _x((4, 8), 3)
    for _ in range(2):
        (ref(paddle.to_tensor(x)) ** 2).mean().backward()
        jopt.step()
        jopt.clear_grad()
        (port(torch.from_numpy(x)) ** 2).mean().backward()
        topt.step()
        topt.clear_grad()
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))),
                               _np(ref(paddle.to_tensor(x))), atol=ATOL,
                               rtol=0)
    assert port.forward.captures == 1


def test_batch_norm_buffers_are_written_back():
    paddle.seed(4)
    ref = jnn.Sequential(jnn.Linear(4, 6), jnn.BatchNorm1D(6))
    port = tnn.Sequential(tnn.Linear(4, 6), tnn.BatchNorm1D(6))
    load_named_params(port, _named(ref))
    jjit.to_static(ref)
    tjit.to_static(port)
    for seed in (5, 6):
        x = _x((8, 4), seed)
        out_j = ref(paddle.to_tensor(x))
        out_t = port(torch.from_numpy(x))
        np.testing.assert_allclose(_np(out_t), _np(out_j), atol=ATOL, rtol=0)
    bj = {n: np.asarray(b._data) for n, b in ref.named_buffers()}
    bt = {n: b.numpy() for n, b in port.named_buffers()}
    assert set(bj) == set(bt) and bt
    for n in bj:
        np.testing.assert_allclose(bt[n], bj[n], atol=ATOL, rtol=0,
                                   err_msg=n)
    assert not np.allclose(bt["1._mean"], 0)
    port.eval()
    before = {n: b.clone() for n, b in port.named_buffers()}
    port(torch.from_numpy(_x((8, 4), 7)))
    assert all(torch.equal(b, before[n]) for n, b in port.named_buffers())


def test_dropout_is_fresh_at_each_call():
    class Drop(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Linear(8, 8)

        def forward(self, x):
            return TF.dropout(self.fc(x), p=0.5, training=self.training)

    net = tjit.to_static(Drop())
    x = torch.ones(4, 8)
    tpt.seed(0)
    a, b = net(x), net(x)
    assert not torch.equal(a, b) and net.forward.captures == 1
    tpt.seed(0)
    assert torch.equal(net(x), a)
    net.eval()
    assert torch.equal(net(x), net(x)) and net.forward.captures == 2


def test_plain_function_and_tree_structure():
    def f(x, y):
        return {"sum": x * y + 2.0, "pair": (x - y, y)}

    a, b = np.arange(4, dtype=np.float32), np.full(4, 3, np.float32)
    want = jjit.to_static(f)(paddle.to_tensor(a), paddle.to_tensor(b))
    sf = tjit.to_static(f)
    got = sf(torch.from_numpy(a), torch.from_numpy(b))
    assert set(got) == {"sum", "pair"} and isinstance(got["pair"], tuple)
    np.testing.assert_allclose(got["sum"].numpy(), _np(want["sum"]))
    np.testing.assert_allclose(got["pair"][0].numpy(),
                               _np(want["pair"][0]))
    assert tjit.not_to_static(f) is f and f._not_to_static
    with pytest.raises(NotImplementedError, match="item 8"):
        sf.analyze(a, b)


def _loss_layer(model):
    """A Layer that holds the GPT and returns ``gpt_loss`` of its batch,
    so that the capture takes the GPT's parameters as inputs."""
    class L(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.gpt = model

        def forward(self, ids):
            return gpt_loss(self.gpt, ids, ids)
    return L()


@pytest.fixture(scope="module")
def gpt_ref_grads():
    """The reference's loss and gradients of gpt_tiny by head, as its
    TrainStep takes them (``jax.value_and_grad`` of
    ``functional_loss_call`` under ``jax.jit``: one compile, where its
    eager ops compile one by one): its fused CE head the Pallas kernel in
    interpret mode, its attention dense (``use_flash_attention=False``;
    ``tests/test_torch_flash_attention.py`` holds the port's plain flash
    version to the Pallas kernels)."""
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfa._INTERPRET = jce._INTERPRET = True
    try:
        ref = jgpt.GPT(jgpt.gpt_tiny(use_flash_attention=False, **TINY))
        init = {n: np.array(ref._parameters[n]._data)
                for n in jgpt._PARAM_ORDER}
        ids = np.random.default_rng(9).integers(0, 256, (2, 128)).astype(
            np.int64)
        params = {n: p._data for n, p in ref.named_parameters()}
        out = {}
        for fused in (False, True):
            jflags.set_flags({"gpt_fused_ce": fused})
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jjit.functional_loss_call(
                    ref, jgpt.gpt_loss, p, {}, jax.random.PRNGKey(0),
                    [jnp.asarray(ids), jnp.asarray(ids)])[0]))(params)
            out[fused] = (float(loss),
                          {n: np.array(g) for n, g in grads.items()})
    finally:
        jflags.set_flags({"gpt_fused_ce": False})
        jfa._INTERPRET = jce._INTERPRET = False
        set_mesh(prev)
    return init, ids, out


@pytest.mark.parametrize("fused", [False, True])
def test_gpt_tiny_loss_and_gradients_through_the_capture(gpt_ref_grads,
                                                         fused):
    init, ids, want = gpt_ref_grads
    tflags.set_flags({"gpt_fused_ce": fused})
    gpt = GPT(gpt_tiny(**TINY), device="cpu").load_jax_params(init)
    net = tjit.to_static(_loss_layer(gpt))
    loss = net(torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(float(loss), want[fused][0], atol=ATOL,
                               rtol=0)
    for n, g in want[fused][1].items():
        np.testing.assert_allclose(getattr(gpt, n).grad.numpy(), g,
                                   atol=ATOL_GRAD, rtol=0, err_msg=n)
    graph = next(iter(net.forward._cache.values()))[0].graph
    ops = {str(node.target) for node in graph.nodes}
    assert "paddle_tpu_torch.flash_fwd.default" in ops
    assert ("paddle_tpu_torch.fused_ce_fwd.default" in ops) == fused


def test_learned_bias_encoder_dbias_through_the_capture():
    e, nh, s = 128, 2, 128
    paddle.seed(11)
    ref = jnn.TransformerEncoderLayer(e, nh, 256, dropout=0.0)
    port = load_named_params(
        tnn.TransformerEncoderLayer(e, nh, 256, dropout=0.0, device="cpu"),
        _named(ref))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, s, e)).astype(np.float32)
    m = (rng.standard_normal((1, nh, s, s)) * 0.5).astype(np.float32)
    jm = paddle.to_tensor(m, stop_gradient=False)
    # the reference's dense attention (its flash rule refuses the CPU
    # without interpret mode), the exact gradient of the bias
    jfa._INTERPRET = False
    ref(paddle.to_tensor(x), jm).sum().backward()

    class Biased(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.enc = port
            self.bias = torch.nn.Parameter(torch.from_numpy(m))

        def forward(self, x):
            return self.enc(x, self.bias)
    net = tjit.to_static(Biased())
    net(torch.from_numpy(x)).sum().backward()
    tm = net.bias
    np.testing.assert_allclose(tm.grad.numpy(), _np(jm.grad),
                               atol=ATOL_GRAD, rtol=0)
    em = torch.from_numpy(m).requires_grad_()
    port(torch.from_numpy(x), em).sum().backward()
    assert torch.equal(em.grad, tm.grad)


# -- dy2static: the cases of tests/test_dy2static.py --------------------------

def _cases(P):
    """The functions of tests/test_dy2static.py over namespace P (either
    package), by name."""
    def if_tensor(x):
        y = x * 2
        if P.mean(x) > 0:
            y = y + 1
        else:
            y = y - 1
        return y

    def while_tensor(x):
        s = P.zeros([1])
        i = P.zeros([1])
        while P.sum(s) < 10.0:
            s = s + x
            i = i + 1
        return i

    def for_range(x, n):
        acc = P.zeros_like(x)
        for i in range(n):
            acc = acc + x * float(1.0)
        return acc

    def shadowed(x):
        input = x
        if P.mean(x) > 0:
            input = input * 2
            y = input + 1
        else:
            y = input - 1
        return y

    def walrus(x):
        n = 0
        total = x * 0
        while (n := n + 1) < 4:
            total = total + x * n
        return total

    def body_temp(s):
        while P.sum(s) < 10:
            t = s * 2
            s = s + t
        return s

    def branch_temp(x):
        if P.mean(x) > 0:
            t = x * 2
            y = t + 1
        else:
            y = x - 1
        return y

    def read_after(s):
        t = s * 0
        while P.sum(s) < 10:
            t = s * 2
            s = s + t
        return s + t

    return {"if_tensor": if_tensor, "while_tensor": while_tensor,
            "for_range": for_range, "shadowed": shadowed, "walrus": walrus,
            "body_temp": body_temp, "branch_temp": branch_temp,
            "read_after": read_after}


ARGS = {"if_tensor": [[1.0, 2.0], [-1.0, -2.0]],
        "while_tensor": [[3.0]], "shadowed": [[1.0], [-1.0]],
        "walrus": [[1.0]], "body_temp": [[1.0]],
        "branch_temp": [[1.0], [-1.0]], "read_after": [[1.0]]}


@pytest.mark.parametrize("name", sorted(ARGS) + ["for_range"])
def test_dy2static_case_eager_and_captured(name):
    jorig = _cases(paddle)[name]
    jf = jconvert(jorig)
    f = _cases(tpt)[name]
    tf = tconvert(f)
    assert (tf is f) == (jf is jorig) == (name == "walrus")
    sf = tjit.to_static(f)
    if name == "for_range":
        x = np.ones(3, np.float32)
        want = _np(jf(paddle.to_tensor(x), 5))
        np.testing.assert_allclose(tf(torch.from_numpy(x), 5).numpy(), want)
        got = sf(torch.from_numpy(x), torch.tensor(5, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), want)
        return
    for a in ARGS[name]:
        x = np.array(a, np.float32)
        want = _np(jf(paddle.to_tensor(x)))
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(), want)
        np.testing.assert_allclose(sf(torch.from_numpy(x)).numpy(), want)
    assert sf.captures == 1 and sf._cache


def test_dy2static_python_semantics_kept():
    calls = []

    def flagged(x, flag):
        y = x
        if flag:
            y = y + 1
            calls.append("t")
        else:
            y = y - 1
            calls.append("f")
        return y

    g = tconvert(flagged)
    x = torch.zeros(2)
    g(x, True)
    g(x, False)
    assert calls == ["t", "f"]

    def escape(x):
        if x is None:
            return 0
        return x * 2
    g = tconvert(escape)
    assert g(None) == 0 and torch.equal(g(torch.ones(2)), torch.full((2,),
                                                                     2.0))

    def empty(x):
        i = 10
        for i in range(0):
            x = x + 1
        return i
    assert tconvert(empty)(torch.ones(1)) == 10

    def untouched(x):
        return x * 2
    assert tconvert(untouched) is untouched


def test_dy2static_names_a_branch_only_variable_under_capture():
    def f(x):
        if tpt.mean(x) > 0:
            z = x * 2
        return z

    with pytest.raises(NameError, match="only one branch"):
        tjit.to_static(f)(torch.ones(2))


# -- static.nn ------------------------------------------------------------------

def _control(S, P, x, k):
    """Every static.nn function of namespace pair (S = static.nn, P =
    package) on tensor x and index k."""
    c = S.cond(P.mean(x) > 0, lambda: x * 2, lambda: x - 1)
    i, acc = S.while_loop(lambda i, a: P.sum(a) < 20.0,
                          lambda i, a: [i + 1, a + x + 1],
                          [P.zeros([1]), x * 0])
    cs = S.case([(P.mean(x) > 5, lambda: x * 10),
                 (P.mean(x) > 0, lambda: x + 100)], default=lambda: -x)
    sw = S.switch_case(k, {0: lambda: x + 1, 3: lambda: x * 3},
                       default=lambda: x * 0)
    return c, i, acc, cs, sw


@pytest.mark.parametrize("k", [0, 3, 7])
def test_static_nn_eager_and_captured(k):
    x = np.array([1.0, 2.0], np.float32)
    want = _control(jstatic.nn, paddle, paddle.to_tensor(x),
                    paddle.to_tensor(np.int32(k)))
    got_e = _control(tstatic.nn, tpt, torch.from_numpy(x),
                     torch.tensor(k, dtype=torch.int32))
    sf = tjit.to_static(functools.partial(_control, tstatic.nn, tpt))
    got_c = sf(torch.from_numpy(x), torch.tensor(k, dtype=torch.int32))
    for w, e, c in zip(want, got_e, got_c):
        np.testing.assert_allclose(e.numpy(), _np(w))
        np.testing.assert_allclose(c.numpy(), _np(w))
    graph = next(iter(sf._cache.values()))[0].graph
    ops = {n.target for n in graph.nodes}
    assert {torch.ops.higher_order.cond,
            torch.ops.higher_order.while_loop} <= ops, ops


def test_static_surface():
    spec = tstatic.InputSpec([None, 4], "float32")
    assert spec.shape == (-1, 4)
    assert tstatic.InputSpec.from_tensor(torch.zeros(2, 3)).shape == (2, 3)
    with pytest.raises(NotImplementedError, match="to_static"):
        tstatic.Program()
    with pytest.raises(NotImplementedError):
        tstatic.Executor()
    tstatic.enable_static()
    try:
        assert not tpt.in_dygraph_mode() and not tpt.in_dynamic_mode()
    finally:
        tstatic.disable_static()
    assert tpt.in_dygraph_mode()
    with pytest.raises(NotImplementedError, match="item 8"):
        tjit.TrainStep(TNet(), lambda m, x: m(x).sum(),
                       SGD(learning_rate=0.1)).analyze()
