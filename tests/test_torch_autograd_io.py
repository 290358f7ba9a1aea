"""The port's autograd module, ``save`` / ``load`` and the rest of the
top-level namespace against the reference on the CPU.

- ``backward`` / ``grad``: gradients equal to the reference's;
  ``allow_unused``, ``retain_graph`` defaulting to ``create_graph``, the
  double backward of ``create_graph=True``, ``no_grad_vars``, ``.grad``
  left alone; ``no_grad`` / ``enable_grad`` as a context, a bare
  decorator and a called one.
- Checkpoints in both directions: what ``paddle_tpu.save`` writes (f32,
  f64, int64, bool, bf16, nested dicts, lists and tuples, numbers,
  ``Parameter``s) ``paddle_tpu_torch.load`` reads bitwise with dtypes,
  and the other way round; ``dumps`` / ``loads``; a file without the
  sentinel.  A ``gpt_tiny`` (1 layer, H=64, S=32) trained one AdamW
  step by the reference and saved as ``.pdparams`` / ``.pdopt`` resumes
  in the port, whose next step equals the reference's own next step
  within 1e-5.  Optimizer state resumes across packages by parameter
  name: ``ParamAttr`` names agree; the generated names of eager-made
  layers count every tensor made before them in the reference and
  only parameters in the port, so they do not.
- The top-level names: dtypes, aliases, places, ``tanh_`` / ``scatter_``
  in place (data-only on a leaf that requires grad)."""
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import io as jio
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
import paddle_tpu_torch as tpt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.models import GPT, gpt_loss, gpt_tiny
from paddle_tpu_torch.optimizer import Adam, AdamW

from torch_tensor_common import assert_same, rng

TINY = dict(num_layers=1, hidden_size=64, num_heads=2, max_seq_len=64,
            remat=False)
LR = 1e-3


@pytest.fixture(autouse=True)
def _cpu_default():
    """The CPU as the port's default device, and the reference's GPT on
    one device."""
    prev, prev_mesh = tdevice.get_device(), get_mesh()
    tdevice.set_device("cpu")
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    tdevice._default = prev
    set_mesh(prev_mesh)


def _pair(shape=(3, 4), seed=0):
    a = rng(seed).standard_normal(shape).astype(np.float32)
    j = paddle.to_tensor(a)
    j.stop_gradient = False
    return torch.from_numpy(a.copy()).requires_grad_(), j


# -- autograd -----------------------------------------------------------------

def test_backward_matches_the_reference():
    x, jx = _pair()
    g = rng(1).standard_normal((3, 4)).astype(np.float32)
    tpt.autograd.backward([(x * x).sum(), x.exp()],
                          [None, torch.from_numpy(g)])
    paddle.autograd.backward([(jx * jx).sum(), jx.exp()],
                             [None, paddle.to_tensor(g)])
    assert_same(x.grad, jx.grad)
    x2, jx2 = _pair()
    tpt.autograd.backward_from(x2.sin())
    paddle.autograd.backward_from(jx2.sin())
    assert_same(x2.grad, jx2.grad)


def test_grad_leaves_dot_grad_alone():
    x, jx = _pair()
    got = tpt.grad((x ** 3).sum(), x)
    want = paddle.grad((jx ** 3).sum(), jx)
    assert x.grad is None and jx.grad is None
    assert_same(got[0], want[0])


def test_grad_allow_unused():
    x, jx = _pair()
    y, jy = _pair(seed=2)
    with pytest.raises(RuntimeError, match="unused"):
        tpt.grad((x * 2).sum(), [x, y])
    with pytest.raises(RuntimeError, match="unused"):
        paddle.grad((jx * 2).sum(), [jx, jy])
    got = tpt.grad((x * 2).sum(), [x, y], allow_unused=True)
    want = paddle.grad((jx * 2).sum(), [jx, jy], allow_unused=True)
    assert got[1] is None and want[1] is None
    assert_same(got[0], want[0])


def test_retain_graph_defaults_to_create_graph():
    x, _ = _pair()
    out = (x.exp() * x).sum()
    tpt.grad(out, x)
    with pytest.raises(RuntimeError):
        tpt.grad(out, x)                 # freed: retain_graph was False
    out = (x.exp() * x).sum()
    first = tpt.grad(out, x, create_graph=True)[0]
    assert first.requires_grad
    again = tpt.grad(out, x)[0]          # retained
    torch.testing.assert_close(again, first.detach())


def test_double_backward_matches_the_reference():
    x, jx = _pair()
    gx = tpt.grad((x ** 3 * x.sin()).sum(), x, create_graph=True)[0]
    jg = paddle.grad((jx ** 3 * jx.sin()).sum(), jx, create_graph=True)[0]
    assert_same(gx, jg)
    got = tpt.grad((gx * gx).sum(), x)[0]
    want = paddle.grad((jg * jg).sum(), jx)[0]
    assert_same(got, want)


def test_no_grad_vars_stop_the_gradient():
    x, _ = _pair()
    y = x * 2
    z = (y * y + x).sum()
    got = tpt.grad(z, x, no_grad_vars=[y], retain_graph=True)[0]
    assert torch.equal(got, torch.ones_like(x))
    assert torch.equal(tpt.grad(z, x)[0], 8 * x.detach() + 1)


def test_no_grad_forms():
    x = torch.ones(2, requires_grad=True)

    @tpt.no_grad
    def bare():
        return x * 2

    @tpt.no_grad()
    def called():
        return x * 2

    assert not bare().requires_grad and not called().requires_grad
    with tpt.no_grad():
        assert not tpt.is_grad_enabled()
        assert not (x * 2).requires_grad
        with tpt.enable_grad():
            assert (x * 2).requires_grad
    assert tpt.enable_grad(lambda: (x * 2).requires_grad)()
    tpt.set_grad_enabled(False)
    try:
        assert not tpt.is_grad_enabled()
    finally:
        tpt.set_grad_enabled_(True)
    assert tpt.is_grad_enabled()
    with tpt.set_grad_enabled(False):
        assert not (x * 2).requires_grad
    assert tpt.autograd.no_grad is tpt.no_grad


# -- checkpoints --------------------------------------------------------------

def _payload_np():
    r = rng(3)
    return {"f32": r.standard_normal((3, 5)).astype(np.float32),
            "f64": r.standard_normal(4),
            "i64": r.integers(-9, 9, (2, 3)),
            "b": r.random(6) > 0.5,
            "bf16": r.standard_normal((4, 7)).astype(np.float32)}


def _ref_payload():
    a = _payload_np()
    t = {k: paddle.to_tensor(v) for k, v in a.items() if k != "bf16"}
    t["bf16"] = paddle.to_tensor(a["bf16"]).astype("bfloat16")
    w = paddle.Parameter(a["f32"] * 2, name="layer.w")
    return {"nested": {"inner": [t["f32"], (t["i64"], 3.5)], "n": 7},
            "f64": t["f64"], "b": t["b"], "bf16": t["bf16"], "w": w,
            "pow": [0.9, 0.999], "name": "x",
            "bf16_0d": t["bf16"][1, 2], "f32_0d": t["f32"][0, 0]}


def _port_payload():
    a = _payload_np()
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    t["bf16"] = t["bf16"].to(torch.bfloat16)
    w = tpt.Parameter(torch.from_numpy(a["f32"] * 2), name="layer.w")
    return {"nested": {"inner": [t["f32"], (t["i64"], 3.5)], "n": 7},
            "f64": t["f64"], "b": t["b"], "bf16": t["bf16"], "w": w,
            "pow": [0.9, 0.999], "name": "x",
            "bf16_0d": t["bf16"][1, 2], "f32_0d": t["f32"][0, 0]}


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (str(t.dtype).replace("torch.", ""), tuple(t.shape),
                (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                .numpy().tobytes())
    a = np.asarray(t._data)
    name = a.dtype.name
    if name == "bfloat16":
        a = a.view(np.int16)
    return name, a.shape, a.tobytes()


def _same_structure(port, ref):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and port.keys() == ref.keys()
        for k in ref:
            _same_structure(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for a, b in zip(port, ref):
            _same_structure(a, b)
    elif isinstance(ref, paddle.Tensor):
        assert isinstance(port, torch.Tensor)
        assert _bits(port) == _bits(ref)
        assert isinstance(port, tpt.Parameter) == isinstance(
            ref, paddle.Parameter)
        if isinstance(ref, paddle.Parameter):
            assert port.name == ref.name
    else:
        assert port == ref and type(port) is type(ref)


def test_reference_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "ref" / "x.pdparams")
    paddle.save(_ref_payload(), path)
    got = tpt.load(path)
    _same_structure(got, _ref_payload())
    assert got["bf16"].dtype == torch.bfloat16
    raw = tpt.load(path, return_numpy=True)
    assert raw["bf16"].dtype == np.dtype("V2") and raw["f64"].dtype == \
        np.float64


def test_port_file_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "port" / "x.pdparams")
    tpt.save(_port_payload(), path)
    got = paddle.load(path)
    _same_structure(_port_payload(), got)
    assert got["bf16"].dtype == paddle.bfloat16
    _same_structure(tpt.load(path), got)


def test_bf16_loads_without_ml_dtypes(tmp_path, monkeypatch):
    """The reference's bf16 file read where ml_dtypes cannot be
    imported."""
    path = str(tmp_path / "bf16.pdparams")
    x = rng(8).standard_normal((3, 4)).astype(np.float32)
    paddle.save({"w": paddle.to_tensor(x).astype("bfloat16")}, path)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    w = tpt.load(path)["w"]
    assert w.dtype == torch.bfloat16
    assert torch.equal(w.view(torch.int16),
                       torch.from_numpy(x).to(torch.bfloat16).view(
                           torch.int16))


def test_dumps_loads_and_no_sentinel():
    import pickle
    blob = tio.dumps(_port_payload())
    assert blob[:5] == b"PTPU1"
    _same_structure(tio.loads(blob), jio.loads(blob))
    _same_structure(tio.loads(jio.dumps(_ref_payload())), _ref_payload())
    plain = pickle.dumps({"a": 1, "v": [2.0]}, protocol=4)
    assert tio.loads(plain) == {"a": 1, "v": [2.0]}


def test_gpt_tiny_resumes_from_the_reference_checkpoint(tmp_path):
    """The reference trains with its TrainStep, which keeps the AdamW
    state outside the optimizer: the test hands the state after step 1
    to the optimizer, whose state_dict() then writes the .pdopt."""
    ids = rng(4).integers(0, 256, (2, 32)).astype(np.int64)
    ref = jgpt.GPT(jgpt.gpt_tiny(**TINY))
    ropt = jopt.AdamW(learning_rate=LR, parameters=ref.parameters())
    rstep = JTrainStep(ref, jgpt.gpt_loss, ropt)
    rstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
    for name, p in ref._parameters.items():
        ropt._accumulators[id(p)] = dict(rstep._opt_states[name])
    paddle.save(ref.state_dict(), str(tmp_path / "gpt.pdparams"))
    paddle.save(ropt.state_dict(), str(tmp_path / "gpt.pdopt"))
    loss2 = float(rstep(paddle.to_tensor(ids), paddle.to_tensor(ids)))
    model = GPT(gpt_tiny(**TINY), device="cpu")
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    missing, unexpected = model.set_state_dict(
        tpt.load(str(tmp_path / "gpt.pdparams")))
    assert not missing and not unexpected
    sd = tpt.load(str(tmp_path / "gpt.pdopt"))
    assert len(sd) == 4 * 16 + 1 and sd["@global_step"] == 1
    _same_structure(tpt.load(str(tmp_path / "gpt.pdparams")),
                    paddle.load(str(tmp_path / "gpt.pdparams")))
    _same_structure(sd, paddle.load(str(tmp_path / "gpt.pdopt")))
    opt.set_state_dict(sd)
    assert set(opt.state_dict()) == set(sd)
    loss = gpt_loss(model, torch.from_numpy(ids), torch.from_numpy(ids))
    loss.backward()
    opt.step()
    assert abs(float(loss) - loss2) <= 1e-5
    want = ref.state_dict()
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), np.asarray(want[name]._data),
                                   rtol=0, atol=1e-5, err_msg=name)
    for name, p in model.named_parameters():
        st = opt._state_for(p)
        for k, v in rstep._opt_states[name].items():
            np.testing.assert_allclose(st[k].numpy(), np.asarray(v),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name} {k}")
    # and back: the port's state dicts after its step, read by the
    # reference
    tpt.save(model.state_dict(), str(tmp_path / "port.pdparams"))
    tpt.save(opt.state_dict(), str(tmp_path / "port.pdopt"))
    _same_structure(model.state_dict(),
                    paddle.load(str(tmp_path / "port.pdparams")))
    _same_structure(opt.state_dict(),
                    paddle.load(str(tmp_path / "port.pdopt")))


def test_optimizer_state_resumes_by_parameter_name(tmp_path):
    """Two layers, one with ParamAttr names, one with generated ones,
    under one reference Adam step."""
    names = {"weight_attr": "fc.w", "bias_attr": "fc.b"}
    refs = [jnn.Linear(4, 3, **{k: jnn.ParamAttr(name=v)
                                for k, v in names.items()}),
            jnn.Linear(4, 3)]
    ropt = jopt.Adam(learning_rate=0.1, parameters=refs[0].parameters()
                     + refs[1].parameters())
    x = paddle.to_tensor(rng(5).standard_normal((2, 4)).astype(np.float32))
    (refs[0](x).sum() + refs[1](x).sum()).backward()
    ropt.step()
    paddle.save(ropt.state_dict(), str(tmp_path / "o.pdopt"))
    ports = [tnn.Linear(4, 3, device="cpu", **{
        k: tnn.ParamAttr(name=v) for k, v in names.items()}),
        tnn.Linear(4, 3, device="cpu")]
    opt = Adam(learning_rate=0.1, parameters=ports[0].parameters()
               + ports[1].parameters())
    sd = tpt.load(str(tmp_path / "o.pdopt"))
    opt.set_state_dict(sd)
    shared = set(opt.state_dict()) & set(sd) - {"@global_step"}
    # ParamAttr names agree; generated_tensor_{n} numbers do not
    assert shared == {f"fc.{p}_{k}" for p in "wb" for k in (
        "moment1", "moment2", "beta1_pow", "beta2_pow")}
    assert_same(opt.state_dict()["fc.w_moment1"],
                ropt.state_dict()["fc.w_moment1"])
    assert not bool(opt._state_for(ports[1].weight)["moment1"].any())


# -- the top-level namespace --------------------------------------------------

def test_dtypes_and_aliases():
    assert torch.zeros(2).dtype == tpt.float32 and tpt.bool is torch.bool
    for n in ("float16", "bfloat16", "float32", "float64", "int8", "uint8",
              "int16", "int32", "int64", "complex64", "complex128"):
        assert getattr(tpt, n) is getattr(torch, n)
    assert tpt.reduce_mean is tpt.mean is tpt.tensor.stat.mean
    assert tpt.elementwise_add is tpt.add and tpt.crop_tensor is tpt.crop
    assert tpt.reduce_sum is tpt.sum and tpt.elementwise_pow is tpt.pow
    assert tpt.Tensor is tpt.LoDTensor is tpt.VarBase is torch.Tensor
    assert tpt.LoDTensorArray is list
    assert tpt.convert_dtype("fp16") == torch.float16
    assert tpt.CPUPlace() == torch.device("cpu") == tpt.CUDAPinnedPlace()
    assert tpt.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert not tpt.is_compiled_with_tpu() and not tpt.is_compiled_with_xpu()
    assert tpt.in_dynamic_mode() and tpt.in_dygraph_mode()
    assert tpt.device_count() >= 1 and tpt.full_version == tpt.__version__
    assert tpt.get_flags("gpt_fused_ce") == {"gpt_fused_ce": False}


def test_compat_functions():
    x = torch.tensor([[1.0, float("nan")], [float("inf"), 2.0]])
    assert bool(tpt.has_nan(x)) and bool(tpt.has_inf(x))
    assert not bool(tpt.has_nan(torch.ones(2)))
    assert int(tpt.rank(x)) == 2 and tpt.rank(x).dtype == torch.int64
    assert tpt.shape(x).tolist() == [2, 2] and tpt.shape(x).dtype == \
        torch.int32
    assert tpt.broadcast_shape([3, 1], [4]) == [3, 4]
    c = tpt.fill_constant([2, 3], "int32", 7)
    assert c.dtype == torch.int32 and int(c.sum()) == 42
    g = tpt.create_global_var([2], 0.5, "float32", persistable=True)
    assert g.persistable and not g.requires_grad
    dense = torch.sparse_coo_tensor([[0, 2]], torch.ones(2, 3), (4, 3))
    assert torch.equal(tpt.get_tensor_from_selected_rows(dense),
                       dense.to_dense())


def test_in_place_tanh_and_scatter():
    leaf = torch.tensor([0.5, -1.0], requires_grad=True)
    assert tpt.tanh_(leaf) is leaf and leaf.is_leaf
    assert torch.equal(leaf.detach(), torch.tanh(torch.tensor([0.5, -1.0])))
    x, jx = _pair()
    y, jy = x * 1.0, jx * 1.0
    assert tpt.tanh_(y) is y
    paddle.tanh_(jy)
    (y * 3).sum().backward()
    (jy * 3).sum().backward()
    assert_same(x.grad, jx.grad)
    x, jx = _pair(seed=6)
    upd = rng(7).standard_normal((2, 4)).astype(np.float32)
    y, jy = x * 2.0, jx * 2.0
    idx = np.array([2, 2])
    tpt.scatter_(y, torch.from_numpy(idx), torch.from_numpy(upd))
    paddle.scatter_(jy, paddle.to_tensor(idx), paddle.to_tensor(upd))
    assert_same(y, jy)
    y.sum().backward()
    jy.sum().backward()
    assert_same(x.grad, jx.grad)
