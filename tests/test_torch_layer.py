"""The port's ``nn.Layer`` and its containers against the reference's
(``paddle_tpu/nn/layer/layers.py``) on the CPU: every ``Layer`` method of
``API.spec``, ``Sequential`` from (name, layer) pairs and its slices,
``LayerList`` and ``ParameterList``, the hooks' order, ids and removal,
``state_dict``'s key order, ``set_state_dict``'s missing and unexpected
keys, ``apply``'s order, and a user's ``class Net(nn.Layer)`` trained one
eager step and carried by its state dict.  Weights carry by name
(``load_named_params``); values are compared exactly or at 1e-6.  The
PyTorch side still works: ``functional_call``, ``eval``, ``.to``,
``load_state_dict``, and every layer and model of the port is a
``Layer``."""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.models import load_named_params

ROOT = Path(__file__).resolve().parents[1]
SPEC = sorted(re.findall(r"^paddle_tpu\.nn\.Layer\.(\w+) ",
                         (ROOT / "API.spec").read_text(), re.M))
TOL = dict(rtol=1e-6, atol=1e-6)


def _named(layer):
    return {n: np.array(p._data) for n, p in layer.named_parameters()}


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(make_ref, make_port):
    """The reference layer and the port's, the port's weights copied from
    the reference's by name."""
    ref = make_ref()
    return ref, load_named_params(make_port(), _named(ref))


def _out(layer, x):
    if isinstance(layer, jnn.Layer):
        return np.asarray(layer(paddle.to_tensor(x))._data)
    return layer(torch.from_numpy(x)).detach().numpy()


def test_api_spec_lists_31_layer_methods():
    assert len(SPEC) == 31


@pytest.mark.parametrize("name", SPEC)
def test_layer_has_the_reference_method(name):
    assert callable(getattr(tnn.Layer, name)), name
    assert callable(getattr(jnn.Layer, name)), name


def _port_layer_classes():
    import paddle_tpu_torch.jit.recompute as rec
    from paddle_tpu_torch import models
    from paddle_tpu_torch.vision import models as vm
    found = {}
    for mod in (tnn, models, vm):
        for name, obj in vars(mod).items():
            if inspect.isclass(obj) and issubclass(obj, torch.nn.Module):
                found[f"{mod.__name__}.{name}"] = obj
    found["jit.recompute._Bound"] = rec._Bound
    return found


def test_every_port_layer_and_model_is_a_layer():
    classes = _port_layer_classes()
    assert len(classes) > 120
    bad = [n for n, c in classes.items() if not issubclass(c, tnn.Layer)]
    assert not bad, bad


def _seq_pair():
    def make(nn, **kw):
        return nn.Sequential(("fc", nn.Linear(3, 4, **kw)),
                             ("act", nn.ReLU()),
                             ("head", nn.Linear(4, 2, **kw)))
    return _pair(lambda: make(jnn), lambda: make(tnn, device="cpu"))


def test_sequential_from_name_layer_pairs():
    """(name, layer) pairs name the parameters ``fc.weight``, ...; the
    outputs agree."""
    ref, port = _seq_pair()
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()] == [
        "fc.weight", "fc.bias", "head.weight", "head.bias"]
    x = _x(5, 3)
    np.testing.assert_allclose(_out(port, x), _out(ref, x), **TOL)
    assert isinstance(port.fc, tnn.Linear) and len(port) == len(ref) == 3


def test_sequential_index_and_slice():
    """An index picks by place (negative too); a slice is a new
    Sequential whose layers are renamed 0, 1, ..."""
    ref, port = _seq_pair()
    assert port[-1] is port.head and port[0] is port.fc
    for sl in (slice(1, None), slice(0, 1), slice(None, None, 2)):
        r, p = ref[sl], port[sl]
        assert isinstance(p, tnn.Sequential)
        assert [n for n, _ in p.named_parameters()] == [
            n for n, _ in r.named_parameters()]
    x = _x(5, 4)
    np.testing.assert_allclose(_out(port[1:], x), _out(ref[1:], x), **TOL)
    positional = tnn.Sequential(tnn.Linear(3, 4, device="cpu"), tnn.ReLU())
    assert [n for n, _ in positional.named_parameters()] == ["0.weight",
                                                             "0.bias"]
    assert [type(m) for m in positional] == [tnn.Linear, tnn.ReLU]


def test_layer_list_insert_setitem_extend():
    """LayerList's insert renames by place, setitem replaces in place,
    extend / append number on: the parameter names follow the
    reference's."""
    def run(nn, **kw):
        ll = nn.LayerList([nn.Linear(2, 3, **kw), nn.Linear(3, 4, **kw)])
        ll.insert(1, nn.Linear(5, 6, **kw))
        ll[0] = nn.Linear(7, 8, **kw)
        ll.append(nn.Linear(1, 1, **kw))
        ll.extend([nn.Linear(2, 2, **kw)])
        return ll
    ref, port = run(jnn), run(tnn, device="cpu")
    names = [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in port.named_parameters()] == names
    assert [tuple(p.shape) for p in port.parameters()] == [
        tuple(p.shape) for p in ref.parameters()]
    assert len(port) == len(ref) == 5
    assert [type(m).__name__ for m in port] == [
        type(m).__name__ for m in ref]
    assert isinstance(port[1:3], tnn.LayerList) and len(port[1:3]) == 2


def test_parameter_list():
    def run(nn, param):
        pl = nn.ParameterList([param((2,)), param((3, 4))])
        pl.append(param((5,)))
        return pl
    ref = run(jnn, lambda s: paddle.create_parameter(list(s), "float32"))
    port = run(tnn, lambda s: torch.nn.Parameter(torch.zeros(s)))
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()] == ["0", "1", "2"]
    assert [tuple(p.shape) for p in port] == [tuple(p.shape) for p in ref]
    assert tuple(port[1].shape) == (3, 4) and len(port) == 3


def _hooked(nn, **kw):
    """A Linear with two pre-hooks and two post-hooks interleaved; each
    appends to the log.  Returns (layer, log, handles)."""
    layer = nn.Linear(3, 2, **kw)
    log = []

    def pre(tag, scale):
        def hook(lyr, inputs):
            log.append(tag)
            return inputs[0] * scale
        return hook

    def post(tag, shift):
        def hook(lyr, inputs, outputs):
            log.append(tag)
            return outputs + shift
        return hook
    handles = [layer.register_forward_pre_hook(pre("pre1", 2.0)),
               layer.register_forward_post_hook(post("post1", 1.0)),
               layer.register_forward_pre_hook(pre("pre2", 3.0)),
               layer.register_forward_post_hook(post("post2", 10.0))]
    return layer, log, handles


def test_hooks_order_ids_and_removal():
    """Pre-hooks run in order and replace the inputs, post-hooks then run
    in order and replace the outputs; the two kinds share the layer's
    counter (ids 1-4); a removed hook no longer runs."""
    ref, log_r, h_r = _hooked(jnn)
    port, log_p, h_p = _hooked(tnn, device="cpu")
    load_named_params(port, _named(ref))
    assert [h._key for h in h_p] == [h._key for h in h_r] == [1, 2, 3, 4]
    assert all(isinstance(h, tnn.HookRemoveHelper) for h in h_p)
    x = _x(4, 3)
    for remove in (None, 0, 3):
        if remove is not None:
            h_r[remove].remove()
            h_p[remove].remove()
        del log_r[:], log_p[:]
        np.testing.assert_allclose(_out(port, x), _out(ref, x), **TOL)
        assert log_p == log_r
    assert log_p == ["pre2", "post1"]


def _net(nn, **kw):
    """The nested model of the state-dict tests: a BatchNorm's buffers, a
    non-persistable buffer two levels down, a sublayer added by name."""
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4, **kw)
            self.bn = nn.BatchNorm1D(4, **kw)
            self.register_buffer("scratch", self.fc.weight * 0,
                                 persistable=False)

        def forward(self, x):
            return self.bn(self.fc(x))

    class Outer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = nn.Linear(3, 4, **kw)
            self.add_sublayer("block", Block())
            self.register_buffer("count", self.stem.bias * 0)

        def forward(self, x):
            return self.block(self.stem(x))
    return Outer()


def test_state_dict_orders_parameters_then_buffers():
    ref, port = _pair(lambda: _net(jnn), lambda: _net(tnn, device="cpu"))
    keys = list(ref.state_dict())
    assert keys == ["stem.weight", "stem.bias", "block.fc.weight",
                    "block.fc.bias", "block.bn.weight", "block.bn.bias",
                    "count", "block.bn._mean", "block.bn._variance"]
    assert list(port.state_dict()) == keys
    sd = port.state_dict()
    assert not sd["stem.weight"].requires_grad
    assert port.state_dict(keep_vars=True)["stem.weight"] is port.stem.weight
    assert list(port.state_dict(structured_name_prefix="m.")) == [
        "m." + k for k in keys]
    assert list(port.block.state_dict(include_sublayers=False)) == []


def test_set_state_dict_missing_unexpected_and_shape():
    ref, port = _pair(lambda: _net(jnn), lambda: _net(tnn, device="cpu"))
    src = {k: v.numpy() for k, v in ref.state_dict().items()}
    src["block.fc.bias"] = src["block.fc.bias"] + 1.0
    del src["count"]
    src["extra"] = np.zeros(3, np.float32)
    got = port.set_state_dict(dict(src))
    want = ref.set_state_dict(dict(src))
    assert [list(g) for g in got] == [list(w) for w in want] == [
        ["count"], ["extra"]]
    np.testing.assert_array_equal(port.block.fc.bias.detach().numpy(),
                                  src["block.fc.bias"])
    assert port.set_dict is not None and port.load_dict is not None
    bad = {"stem.bias": np.zeros(5, np.float32)}
    with pytest.raises(ValueError):
        port.set_state_dict(bad)
    with pytest.raises(ValueError):
        ref.set_state_dict(bad)


def test_apply_named_sublayers_and_full_name():
    """apply visits the layer first, then pre-order (PyTorch's own order
    is post-order); named_sublayers and full_name as the reference's."""
    ref, port = _net(jnn), _net(tnn, device="cpu")
    seen = {"ref": [], "port": []}
    ref.apply(lambda m: seen["ref"].append(type(m).__name__))
    port.apply(lambda m: seen["port"].append(type(m).__name__))
    assert seen["port"] == seen["ref"] == [
        "Outer", "Linear", "Block", "Linear", "BatchNorm1D"]
    for inc in (False, True):
        assert [n for n, _ in port.named_sublayers(include_self=inc)] == [
            n for n, _ in ref.named_sublayers(include_self=inc)]
        assert len(port.sublayers(include_self=inc)) == len(
            ref.sublayers(include_self=inc))
    assert [n for n, _ in port.named_children()] == ["stem", "block"]
    assert port.full_name() == ref.full_name() == "outer"
    assert tnn.Layer("scope").full_name() == jnn.Layer("scope").full_name()


def test_registry_methods_and_setattr():
    """add_parameter / add_sublayer / register_buffer return what they
    add; create_parameter makes a Xavier-uniform weight or a zero bias
    with the attr's name; assigning a tensor to a parameter's name
    copies it in place; parameters / buffers are lists, with or without
    the sublayers'."""
    port = _net(tnn, device="cpu")
    p = port.create_parameter([3, 2], attr=tnn.ParamAttr(name="w_extra"),
                              device="cpu")
    assert port.add_parameter("extra", p) is p and p.name == "w_extra"
    b = port.create_parameter([2], is_bias=True, device="cpu")
    assert torch.equal(b, torch.zeros(2))
    lin = tnn.Linear(2, 2, device="cpu")
    assert port.add_sublayer("tail", lin) is lin
    t = torch.ones(2)
    assert port.register_buffer("ones", t) is t
    assert isinstance(port.parameters(), list)
    assert len(port.parameters(include_sublayers=False)) == 1
    assert len(port.parameters()) == 9
    assert len(port.buffers(include_sublayers=False)) == 2
    w = port.stem.weight
    port.stem.weight = torch.full((3, 4), 0.5)
    assert port.stem.weight is w and torch.equal(w, torch.full((3, 4), 0.5))
    with pytest.raises(ValueError):
        port.stem.weight = torch.zeros(2)


def test_dtype_moves_and_clear_gradients():
    port = _net(tnn, device="cpu")
    for fn, dt in (("bfloat16", torch.bfloat16), ("half", torch.float16),
                   ("float", torch.float32)):
        assert getattr(port, fn)() is port
        assert {p.dtype for p in port.parameters()} == {dt}
        assert port.block._dtype == str(dt).replace("torch.", "")
    port.astype("bfloat16")
    assert port.stem.weight.dtype == torch.bfloat16
    port.to(dtype="float32", blocking=True)
    port.to(torch.float64)
    assert port.block.bn._mean.dtype == torch.float64
    port.to("cpu", torch.float32)
    assert port.stem.weight.dtype == torch.float32
    port(torch.from_numpy(_x(6, 3))).sum().backward()
    assert port.stem.weight.grad is not None
    port.clear_gradients()
    assert all(p.grad is None for p in port.parameters())
    params, buffers = port.functional_state()
    assert list(params) == [n for n, _ in port.named_parameters()]
    assert "block.bn._mean" in buffers and not params[
        "stem.weight"].requires_grad


def test_torch_callers_still_work():
    """functional_call, eval / train, load_state_dict and the
    torch-style named_parameters arguments."""
    ref, port = _pair(lambda: _net(jnn), lambda: _net(tnn, device="cpu"))
    x = torch.from_numpy(_x(6, 3))
    port.eval()
    assert not port.block.bn.training
    base = port(x)
    params = {n: p * 2 for n, p in port.named_parameters(
        remove_duplicate=False)}
    out = torch.func.functional_call(port, params, (x,))
    assert not torch.equal(out, base)
    other = _net(tnn, device="cpu")
    other.load_state_dict(port.state_dict())
    other.eval()
    assert torch.equal(other(x), base)
    assert len(list(port.named_parameters(recurse=False))) == 0
    assert len(list(port.stem.named_parameters("", False))) == 2
    port.train()
    assert port.block.bn.training


class _RefNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.scale = self.create_parameter(
            [4], default_initializer=jnn.initializer.Constant(1.5))
        self.fc = jnn.Linear(3, 4)
        self.add_sublayer("head", jnn.Linear(4, 1))

    def forward(self, x):
        return self.head(paddle.tanh(self.fc(x)) * self.scale)


class _PortNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.scale = self.create_parameter(
            [4], default_initializer=tnn.initializer.Constant(1.5),
            device="cpu")
        self.fc = tnn.Linear(3, 4, device="cpu")
        self.add_sublayer("head", tnn.Linear(4, 1, device="cpu"))

    def forward(self, x):
        return self.head(torch.tanh(self.fc(x)) * self.scale)


def test_user_net_trains_one_step_and_round_trips():
    """A user's ``class Net(nn.Layer)``: one eager Adam step, card-free,
    against the reference (parameters 1e-6), then its state dict into a
    fresh Net gives the same outputs."""
    ref, port = _pair(_RefNet, _PortNet)
    x, y = _x(8, 3, seed=1), _x(8, 1, seed=2)
    jo = jopt.Adam(learning_rate=0.1, parameters=ref.parameters())
    to = topt.Adam(learning_rate=0.1, parameters=port.parameters())
    jl = ((ref(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
    jl.backward()
    jo.step()
    tl = ((port(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    tl.backward()
    to.step()
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    for n, want in _named(ref).items():
        np.testing.assert_allclose(got[n], want, err_msg=n, **TOL)
    fresh = _PortNet()
    missing, unexpected = fresh.set_state_dict(port.state_dict())
    assert missing == [] and unexpected == []
    np.testing.assert_array_equal(_out(fresh, x), _out(port, x))
