"""The port's AMP (paddle_tpu_torch/amp) against the reference's on the
CPU.

- ``auto_cast`` O1 and O2 on ``gpt_tiny`` and on MobileNetV2 (scale 0.25,
  32x32, eval): the sequence of ops each package casts, with the dtypes of
  each op's floating inputs after the cast, must be the same (the
  reference's record filtered to the ops the port casts: its tensor-method
  ops are PyTorch's in the port), and so must the outputs' dtypes; the
  values agree within 1e-4 where everything runs in f32 (GPT under O1),
  within bf16 rounding elsewhere (2e-2 on GPT's loss, 5e-2 of the logits'
  scale on MobileNetV2).
- ``GradScaler``'s state machine through planted infs: the skipped steps,
  the halving after ``decr_every_n_nan_or_inf`` bad steps, the growth after
  ``incr_every_n_steps`` good ones, parameters 1e-6.
- The dygraph loop of the card's eager-gpt phase at ``gpt_tiny``:
  ``decorate`` O2, ``auto_cast`` O2, ``GradScaler`` and
  ``AdamW(use_fused=True)``, 2 steps against the reference with its fused
  Adam in interpret mode, at beta2 = 0.999 (lr_t 0 in bf16) and 0.99: the
  gradients within 2e-2 of their norm; stepped on the reference's
  gradients from its state, every bf16 parameter and moment within 1 bf16
  ulp (plus 1 f32 ulp of the sum's largest input, for XLA's multiply-add).
- The reproduced reference semantics: ``decorate``'s f32 master copy
  that nothing reads, ``minimize``'s own backward, 2^15 loss scaling in
  bf16.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import fused_adam as jfadam
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
from paddle_tpu.vision import models as jvision
import paddle_tpu_torch.amp as tamp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import (GPT, gpt_loss, gpt_tiny,
                                     load_named_buffers, load_named_params,
                                     state_dict_from_jax)
from paddle_tpu_torch.vision.models import mobilenet_v2

TINY = dict(num_layers=2, hidden_size=128, num_heads=2, max_seq_len=128,
            remat=False)
TOL_F32 = 1e-4
TOL_LOSS_BF16 = 2e-2
TOL_LOGITS_BF16 = 5e-2
GPT_OPS = {"gpt_forward", "gpt_loss"}
VISION_OPS = {"conv2d", "batch_norm", "relu6", "adaptive_avg_pool2d",
              "dropout", "linear", "cross_entropy"}


@pytest.fixture(autouse=True)
def _reference_env():
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfadam._INTERPRET = True
    yield
    jfadam._INTERPRET = False
    set_mesh(prev)


def _dt(d):
    return str(d).replace("torch.", "")


@pytest.fixture
def ref_trace(monkeypatch):
    """Record each op the reference casts: (name, input dtypes)."""
    seen = []
    orig = jamp.amp_cast_for_op

    def rec(name, args):
        out = orig(name, args)
        seen.append((name, [_dt(a.dtype) for a in out
                            if isinstance(a, paddle.Tensor)
                            and jnp.issubdtype(a.dtype, jnp.floating)]))
        return out
    monkeypatch.setattr(jamp, "amp_cast_for_op", rec)
    return seen


def _only(trace, names):
    return [(n, [_dt(d) for d in ds]) for n, ds in trace if n in names]


def _gpt_pair(seed=0):
    cfg = dict(TINY, seed=seed)
    paddle.seed(seed)
    ref = jgpt.GPT(jgpt.gpt_tiny(**cfg))
    port = GPT(gpt_tiny(**cfg), device="cpu")
    port.load_jax_params({n: np.asarray(ref._parameters[n]._data)
                          for n in jgpt._PARAM_ORDER})
    return ref, port


def _ids(seed, b=2, s=128, v=256):
    return np.random.default_rng(seed).integers(0, v, (b, s))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_gpt_tiny(level, ref_trace):
    """O2 after decorate, the only way the reference's O2 runs (see
    test_reference_o2_recurses_on_an_f32_input)."""
    ref, port = _gpt_pair()
    if level == "O2":
        jamp.decorate(ref, level="O2")
        tamp.decorate(port, level="O2")
    ids = _ids(1)
    with jamp.auto_cast(level=level):
        want = jgpt.gpt_loss(ref, paddle.to_tensor(ids), paddle.to_tensor(ids))
    with tamp.auto_cast(level=level), tamp.trace_ops() as got_trace:
        got = gpt_loss(port, ids, ids)
    assert _only(got_trace, GPT_OPS) == _only(ref_trace, GPT_OPS)
    bf = "bfloat16" if level == "O2" else "float32"
    assert _only(got_trace, GPT_OPS) == [
        ("gpt_forward", [bf] * len(jgpt._PARAM_ORDER)), ("gpt_loss", [bf])]
    assert _dt(got.dtype) == _dt(want.dtype) == "float32"
    tol = TOL_F32 if level == "O1" else TOL_LOSS_BF16
    assert abs(float(got) - float(want)) <= tol
    # outside auto_cast nothing is cast or recorded
    with tamp.trace_ops() as none:
        gpt_loss(port, ids, ids)
    assert none == []


def _mobilenet_pair():
    paddle.seed(0)
    ref = jvision.mobilenet_v2(scale=0.25, num_classes=10)
    ref.eval()
    port = mobilenet_v2(scale=0.25, num_classes=10, device="cpu")
    port.eval()
    rng = np.random.default_rng(2)
    params = {n: np.asarray(p._data) for n, p in ref.named_parameters()}
    buffers = {n: (np.asarray(b._data) + 0.1 * rng.random(b.shape)).astype(
        np.float32) for n, b in ref.named_buffers()}     # stats in use
    for n, b in ref.named_buffers():
        b._data = jnp.asarray(buffers[n])
    load_named_params(port, params)
    load_named_buffers(port, buffers)
    return ref, port


def _vision_batch():
    r = np.random.default_rng(3)
    return (r.standard_normal((2, 3, 32, 32)).astype(np.float32),
            r.integers(0, 10, (2,)))


def test_auto_cast_mobilenet_v2_o1(ref_trace):
    ref, port = _mobilenet_pair()
    x, y = _vision_batch()
    with jamp.auto_cast(level="O1"):
        want_lg = ref(paddle.to_tensor(x))
        want = JF.cross_entropy(want_lg, paddle.to_tensor(y))
    with tamp.auto_cast(level="O1"), tamp.trace_ops() as got_trace:
        got_lg = port(torch.from_numpy(x))
        got = TF.cross_entropy(got_lg, torch.from_numpy(y))
    assert _only(got_trace, VISION_OPS) == _only(ref_trace, VISION_OPS)
    ops = _only(got_trace, VISION_OPS)
    assert {tuple(d) for n, d in ops if n == "conv2d"} == {
        ("bfloat16", "bfloat16")}
    assert {tuple(d) for n, d in ops if n == "batch_norm"} == {
        ("float32",) * 5}
    assert {tuple(d) for n, d in ops if n == "relu6"} == {("float32",)}
    assert ops[-2:] == [("linear", ["bfloat16"] * 3),
                        ("cross_entropy", ["float32"])]
    assert _dt(got_lg.dtype) == _dt(want_lg.dtype) == "bfloat16"
    assert _dt(got.dtype) == _dt(want.dtype) == "float32"
    w = want_lg.numpy().astype(np.float32)
    err = np.abs(got_lg.float().detach().numpy() - w).max()
    assert err <= TOL_LOGITS_BF16 * (np.abs(w).max() + 0.1)


def test_auto_cast_mobilenet_v2_o2():
    """O2: everything but the black-listed ops in bf16, batch_norm and
    cross_entropy in f32 (the reference cannot run this: the f32 output
    of its batch_norm sends its cast into endless recursion at the next
    op, test_reference_o2_recurses_on_an_f32_input)."""
    _, port = _mobilenet_pair()
    x, y = _vision_batch()
    with tamp.auto_cast(level="O2"), tamp.trace_ops() as got_trace:
        lg = port(torch.from_numpy(x))
        loss = TF.cross_entropy(lg, torch.from_numpy(y))
    ops = _only(got_trace, VISION_OPS)
    want = {"conv2d": ("bfloat16",) * 2, "batch_norm": ("float32",) * 5,
            "relu6": ("bfloat16",), "adaptive_avg_pool2d": ("bfloat16",),
            "linear": ("bfloat16",) * 3, "cross_entropy": ("float32",)}
    assert {n: {tuple(d) for m, d in ops if m == n} for n in want} == {
        n: {d} for n, d in want.items()}
    assert lg.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert torch.isfinite(loss)


def test_reference_o2_recurses_on_an_f32_input():
    """Divergence: the reference's O2 cast is itself an op that O2 casts
    (amp/__init__.py:104-109 through core.apply :845-846), so an f32
    tensor reaching any op outside the black list recurses without end;
    the port casts with Tensor.to, outside the hook."""
    x = np.ones((2, 3), np.float32)
    with pytest.raises(RecursionError):
        with jamp.auto_cast(level="O2"):
            JF.relu6(paddle.to_tensor(x))
    with pytest.raises(RecursionError):
        with jamp.auto_cast(level="O2"):
            jamp.GradScaler().scale(paddle.to_tensor(x))
    with tamp.auto_cast(level="O2"):
        assert TF.relu6(torch.from_numpy(x)).dtype == torch.bfloat16


def test_custom_lists_and_fp16_name():
    x = torch.randn(3, 4)
    w = torch.randn(4, 2)
    with tamp.auto_cast(custom_black_list={"linear"}, dtype="float16"):
        assert TF.linear(x.bfloat16(), w).dtype == torch.float32
    with tamp.auto_cast(custom_white_list={"relu6"}, dtype="float16"):
        assert TF.relu6(x).dtype == torch.bfloat16       # fp16 -> bf16
        assert TF.tanh(x).dtype == torch.float32
    with tamp.auto_cast(level="O2"):
        assert TF.tanh(x).dtype == torch.bfloat16
        with tamp.auto_cast(enable=False):
            assert TF.tanh(x).dtype == torch.float32
    assert TF.linear(x, w).dtype == torch.float32


def test_cast_is_differentiable():
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 2, requires_grad=True)
    with tamp.auto_cast():
        out = TF.linear(x, w)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad.dtype == w.grad.dtype == torch.float32


# -- GradScaler ---------------------------------------------------------------

def _scaler_run(pkg):
    """6 steps of SGD through the scaler on one Linear, an inf planted in
    the gradient at steps 1 and 2: the scales, found-infs and weights."""
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((3, 2)).astype(np.float32)
    xs = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(6)]
    out = []
    if pkg == "ref":
        m = jnn.Linear(3, 2, bias_attr=False)
        m.weight._data = jnp.asarray(w0)
        opt = jopt.SGD(0.1, parameters=m.parameters())
        sc = jamp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2,
                             decr_every_n_nan_or_inf=2)
        for i, x in enumerate(xs):
            sc.scale(m(paddle.to_tensor(x)).mean()).backward()
            if i in (1, 2):
                m.weight._grad._data = m.weight._grad._data.at[0, 0].set(
                    jnp.inf)
            sc.step(opt)
            found = sc._found_inf
            sc.update()
            opt.clear_grad()
            out.append((sc._scale, found, np.asarray(m.weight._data).copy()))
        return out, sc.state_dict()
    m = tnn.Linear(3, 2, bias_attr=False, device="cpu")
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w0))
    opt = topt.SGD(0.1, parameters=list(m.parameters()))
    sc = tamp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2,
                         decr_every_n_nan_or_inf=2)
    for i, x in enumerate(xs):
        sc.scale(m(torch.from_numpy(x)).mean()).backward()
        if i in (1, 2):
            m.weight.grad[0, 0] = float("inf")
        sc.step(opt)
        found = sc._found_inf
        sc.update()
        opt.clear_grad()
        out.append((sc._scale, found, m.weight.detach().numpy().copy()))
    return out, sc.state_dict()


def test_grad_scaler_state_machine():
    got, got_sd = _scaler_run("port")
    want, want_sd = _scaler_run("ref")
    assert [(s, f) for s, f, _ in got] == [(s, f) for s, f, _ in want]
    # step 0 good; 1 bad (skip); 2 bad: halve; 3, 4 good: double at 4
    assert [(s, f) for s, f, _ in got] == [
        (1024.0, False), (1024.0, True), (512.0, True), (512.0, False),
        (1024.0, False), (1024.0, False)]
    assert np.array_equal(got[1][2], got[0][2])          # skipped
    assert np.array_equal(got[2][2], got[0][2])
    for (_, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    assert got_sd == want_sd
    sc = tamp.GradScaler(incr_every_n_steps=2)
    sc.set_state_dict(dict(got_sd, good_steps=1, bad_steps=1))
    assert sc.state_dict() == dict(got_sd, good_steps=1, bad_steps=1)
    prev = sc.tighten_growth(4.0)
    assert sc.state_dict()["incr_every_n_steps"] == 8
    sc.restore_growth(prev)
    assert sc.state_dict()["incr_every_n_steps"] == 2


def test_grad_scaler_scales_by_two_to_the_15_in_bf16():
    """Reproduced: the reference's docstring promises identity scaling in
    bf16, its code multiplies by init_loss_scaling; so does the port."""
    loss = np.float32(1.5)
    assert float(jamp.GradScaler().scale(paddle.to_tensor(loss))) == \
        1.5 * 2.0 ** 15
    assert float(tamp.GradScaler().scale(torch.tensor(loss))) == \
        1.5 * 2.0 ** 15
    with tamp.auto_cast(level="O2"):          # the scale op casts in O2
        assert tamp.GradScaler().scale(torch.tensor(loss)).dtype == \
            torch.bfloat16


def test_minimize_runs_its_own_backward():
    """Reproduced: minimize calls backward() itself, so a caller's own
    backward (kept with retain_graph=True) doubles the gradient in both
    packages; without retain_graph the second backward raises in both."""
    x = np.ones((3, 2), np.float32)
    jm = jnn.Linear(2, 1, bias_attr=False)
    tm = tnn.Linear(2, 1, bias_attr=False, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.asarray(jm.weight._data)))
    w0 = tm.weight.detach().clone()
    jl = jm(paddle.to_tensor(x)).mean()
    jl.backward(retain_graph=True)
    jamp.GradScaler(init_loss_scaling=1.0).minimize(
        jopt.SGD(1.0, parameters=jm.parameters()), jl)
    tl = tm(torch.from_numpy(x)).mean()
    tl.backward(retain_graph=True)
    tamp.GradScaler(init_loss_scaling=1.0).minimize(
        topt.SGD(1.0, parameters=list(tm.parameters())), tl)
    # d(mean(x @ w)) / dw = 1 for every entry: two backwards move it by 2
    np.testing.assert_allclose((w0 - tm.weight).detach().numpy(), 2.0)
    np.testing.assert_allclose(w0.numpy() - np.asarray(jm.weight._data), 2.0)
    with pytest.raises(RuntimeError):
        tl = tm(torch.from_numpy(x)).mean()
        tl.backward()
        topt.SGD(1.0, parameters=list(tm.parameters())).minimize(tl)
    with pytest.raises(RuntimeError):
        jl = jm(paddle.to_tensor(x)).mean()
        jl.backward()
        jopt.SGD(1.0, parameters=jm.parameters()).minimize(jl)


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1), e - 8)


def _f32_ulp(x):
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1), e - 24)


def _assert_within_bf16_ulp(name, got, want, terms):
    """Within 1 bf16 ulp of the larger side, plus 1 f32 ulp of ``terms``
    (the largest input of the sum): the reference's kernel in interpret
    mode runs on XLA's CPU backend, which fuses b1 m + (1 - b1) g into a
    multiply-add, where the port rounds each product as the card's kernel
    does; the two differ by more than a bf16 ulp only where the sum
    cancels."""
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + _f32_ulp(terms)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (name, int(bad.sum()), float(
        np.abs(got - want).max()))


def _f32(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t).astype(
        np.float32)


# beta2 = 0.999 rounds to 1.0 in bf16, so the reference's lr_t is 0 and
# the parameters stay put (reproduced); 0.99 rounds to 0.98828125 and they
# move
@pytest.mark.parametrize("beta2", [0.999, 0.99])
def test_eager_decorate_o2_fused_adamw_gpt_tiny(beta2):
    """The card's eager-gpt loop at gpt_tiny, 2 steps: bf16 parameters and
    state, the bf16 fused Adam (plain version here; the reference's Pallas
    kernel in interpret mode).  Each package's own scaled gradients agree
    within 2e-2 of their norm (two bf16 backwards).  The port then steps on
    the reference's gradients from the reference's parameters and state
    (loaded with ``state_dict_from_jax`` before the second step), so that
    every parameter, moment1 and moment2 is held to the reference's update
    within 1 bf16 ulp (see ``_assert_within_bf16_ulp``)."""
    ref, port = _gpt_pair()
    init = {n: getattr(port, n).detach().clone() for n in jgpt._PARAM_ORDER}
    jo = jopt.AdamW(1e-3, beta2=beta2, parameters=ref.parameters(),
                    use_fused=True)
    ref, jo = jamp.decorate(ref, jo, level="O2")
    jsc = jamp.GradScaler()
    to = topt.AdamW(1e-3, beta2=beta2, parameters=list(port.parameters()),
                    use_fused=True)
    port, to = tamp.decorate(port, to, level="O2")
    tsc = tamp.GradScaler()
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}
    moved = 0
    for step in range(2):
        jsd = {k: v for k, v in jo.state_dict().items()}
        prev = {n: _f32(ref._parameters[n]._data) for n in jgpt._PARAM_ORDER}
        if step:
            with torch.no_grad():
                for n in jgpt._PARAM_ORDER:
                    getattr(port, n).copy_(torch.from_numpy(prev[n]))
            to.set_state_dict(state_dict_from_jax(
                {k: (v.numpy() if hasattr(v, "numpy") else v)
                 for k, v in jsd.items()}))
        ids = _ids(10 + step)
        with jamp.auto_cast(level="O2"):
            jl = jgpt.gpt_loss(ref, paddle.to_tensor(ids),
                               paddle.to_tensor(ids))
        jsc.scale(jl).backward()
        jg = {n: _f32(ref._parameters[n]._grad._data)
              for n in jgpt._PARAM_ORDER}
        jsc.step(jo)
        jsc.update()
        jo.clear_grad()
        with tamp.auto_cast(level="O2"):
            tl = gpt_loss(port, ids, ids)
        tsc.scale(tl).backward()
        for n in jgpt._PARAM_ORDER:
            p = getattr(port, n)
            assert p.grad.dtype == torch.bfloat16
            got = p.grad.float().numpy()
            assert np.linalg.norm(got - jg[n]) <= 2e-2 * np.linalg.norm(
                jg[n]), n
            p.grad = torch.from_numpy(jg[n]).bfloat16()
        tsc.step(to)
        tsc.update()
        to.clear_grad()
        assert abs(float(tl) - float(jl)) <= TOL_LOSS_BF16
        sd, new = to.state_dict(), jo.state_dict()
        for n in jgpt._PARAM_ORDER:
            p = getattr(port, n)
            assert p.dtype == torch.bfloat16
            _assert_within_bf16_ulp(n, p, ref._parameters[n]._data, prev[n])
            moved += int((p.detach() != init[n].bfloat16()).sum())
            g = jg[n] / np.float32(2.0 ** 15)
            for s, terms in (("moment1", g), ("moment2", g * g)):
                key = f"gpt.{n}_{s}"
                assert sd[key].dtype == torch.bfloat16
                old = _f32(jsd[key]) if key in jsd else 0.0
                _assert_within_bf16_ulp(key, sd[key], _f32(new[key]),
                                        np.maximum(np.abs(old),
                                                   np.abs(terms)))
    assert tsc._scale == jsc._scale == 2.0 ** 15
    assert (moved > 0) == (beta2 == 0.99), moved
    assert sd["gpt.wte_beta1_pow"].dtype == torch.bfloat16
    for s in ("beta1_pow", "beta2_pow"):
        assert float(sd[f"gpt.wte_{s}"]) == float(_f32(new[f"gpt.wte_{s}"]))


def test_decorate_keeps_no_master_copy():
    """Reproduced: the reference's decorate O2 keeps an f32 master_data
    that nothing reads (the update runs on the bf16 parameter); the port
    keeps none."""
    m = jnn.Linear(2, 2)
    opt = jopt.SGD(0.5, parameters=m.parameters())
    jamp.decorate(m, opt, level="O2")
    master = np.asarray(m.weight.master_data).copy()
    assert m.weight.dtype == jnp.bfloat16 and master.dtype == np.float32
    m(paddle.to_tensor(np.ones((1, 2), np.float32))).sum().backward()
    opt.step()
    assert np.array_equal(np.asarray(m.weight.master_data), master)
    assert not np.array_equal(np.asarray(m.weight._data).astype(np.float32),
                              master.astype(jnp.bfloat16).astype(np.float32))
    t = tnn.Linear(2, 2, device="cpu")
    tamp.decorate(t, level="O2")
    assert t.weight.dtype == torch.bfloat16
    assert not hasattr(t.weight, "master_data")
