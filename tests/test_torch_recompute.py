"""Activation recompute in the port (paddle_tpu_torch.jit.recompute) against
the same step without it and against the reference JAX package on the CPU.

- GPT (``TINY``: 2 layers, hidden 128, 2 heads of 64, S = 128) and BERT
  (``SMALL``, padded and unpadded) with per-layer ``remat``: the f32 loss
  and every gradient bitwise those of ``remat=False``, and within 1e-4 of
  the reference's ``remat=True`` gradients; the O2 bf16 trajectory with
  ``remat`` bitwise the one without and within 2e-2 of the reference's.
- ``TrainStep(recompute=True)``, alone and around a ``remat`` model:
  parameters and moments after 2 steps bitwise the plain step's, within
  1e-4 of the reference's ``TrainStep(recompute=True)``; the replay's
  forward calls counted.
- dropout drawing from an explicit generator replays the forward's masks
  (a planted replay that redraws fails the same comparison); BatchNorm's
  running stats are updated once (a planted second update fails).
- ``fleet.utils.recompute``: the four cases of
  ``tests/test_recompute_util.py``, a block held against the reference's
  ``recompute``, and a module called inside an O2 ``TrainStep``; its
  replay alone re-enters the O2 cast, a model's remat layer does not.
- ``ShardedUpdateTrainStep`` and ``CompressedAllReduceTrainStep`` with
  ``recompute=True`` bitwise their plain steps at world size 1 over gloo.

Both packages take their flash path: the reference's Pallas kernels in
interpret mode, the port's plain versions on the CPU.  The CPU's
``index_put_(accumulate=True)``, the backward of an embedding gather, sums
in thread order, so two plain steps of the same model need not agree
bitwise: the bitwise comparisons run under
``torch.use_deterministic_algorithms(True)``.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet.utils import recompute as jrecompute
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.jit import TrainStep, loss_and_grads, loss_closure
from paddle_tpu_torch.jit import recompute as trc
from paddle_tpu_torch.models import (GPT, Bert, BertConfig,
                                     bert_pretrain_loss, gpt_loss, gpt_tiny,
                                     load_named_buffers, load_named_params)
from paddle_tpu_torch.nn.functional import common as tcommon
from paddle_tpu_torch.nn.functional import norm as tnorm
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
from paddle_tpu_torch.parallel import init_process_group, make_mesh as tmesh
from paddle_tpu_torch.parallel.dp_meta import CompressedAllReduceTrainStep
from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep

ATOL = 1e-4
ATOL_O2_LOSS = 2e-2
LR = 1e-4
TINY = dict(num_layers=2, hidden_size=128, num_heads=2, max_seq_len=128)
SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=128)
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _env():
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfa._INTERPRET = True
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(det)
    jfa._INTERPRET = False
    set_mesh(prev)


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (2, 128)).astype(
        np.int32)


def _bert_batch(seed, padded):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (2, 128)).astype(np.int32)
    mlm = np.where(rng.random((2, 128)) < 0.15, ids, -100).astype(np.int32)
    nsp = rng.integers(0, 2, (2,)).astype(np.int32)
    if not padded:
        return [ids, mlm, nsp]
    amask = np.arange(128)[None, :] < np.array([128, 70])[:, None]
    return [ids, np.where(amask, mlm, -100).astype(np.int32), nsp,
            amask.astype(np.int32)]


def _np_params(ref, order):
    return {n: np.array(ref._parameters[n]._data) for n in order}


# kind: (reference module, reference config, port model, port loss, batch)
MODELS = {
    "gpt": (jgpt, jgpt.gpt_tiny, lambda c: GPT(gpt_tiny(**c), device="cpu"),
            gpt_loss, lambda: [_ids(0)] * 2),
    "bert": (jbert, lambda **c: jbert.BertConfig(**c),
             lambda c: Bert(BertConfig(**c), device="cpu"),
             bert_pretrain_loss, lambda: _bert_batch(0, False)),
    "bert_padded": (jbert, lambda **c: jbert.BertConfig(**c),
                    lambda c: Bert(BertConfig(**c), device="cpu"),
                    bert_pretrain_loss, lambda: _bert_batch(0, True)),
}


def _pair(kind, remat):
    mod, jcfg, port_of, _, _ = MODELS[kind]
    cfg = dict(TINY if kind == "gpt" else SMALL, remat=remat)
    ref = (mod.GPT if kind == "gpt" else mod.Bert)(jcfg(**cfg))
    init = _np_params(ref, mod._PARAM_ORDER)
    return ref, init, lambda r: port_of(dict(cfg, remat=r)).load_jax_params(
        init)


def _grads(model, loss_fn, batch, recompute_step=False):
    params = dict(model.named_parameters())
    return loss_and_grads(loss_closure(model, loss_fn,
                                       recompute=recompute_step), params,
                          [torch.as_tensor(a) for a in batch])


def _assert_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_remat_gradients_bitwise_and_match_reference(kind):
    ref, _, port = _pair(kind, True)
    mod, _, _, loss_fn, batch = MODELS[kind]
    args = batch()
    want = (jgpt.gpt_loss if kind == "gpt" else jbert.bert_pretrain_loss)(
        ref, *[paddle.to_tensor(a) for a in args])
    want.backward()
    counted = tfa.launches
    loss_r, g_r = _grads(port(True), loss_fn, args)
    loss_p, g_p = _grads(port(False), loss_fn, args)
    assert tfa.launches == counted      # the CPU runs the plain versions
    assert torch.equal(loss_r, loss_p)
    _assert_equal(g_r, g_p)
    assert abs(loss_r.item() - float(want)) <= ATOL
    for n in mod._PARAM_ORDER:
        np.testing.assert_allclose(
            g_r[n].numpy(), np.asarray(ref._parameters[n].grad._data),
            atol=ATOL, rtol=0, err_msg=n)


def _reference_steps(kind, amp_level, steps, remat=True, recompute=False):
    ref, init, port = _pair(kind, remat)
    mod, _, _, _, batch = MODELS[kind]
    opt = jopt.AdamW(learning_rate=LR, parameters=ref.parameters())
    step = JTrainStep(ref, jgpt.gpt_loss if kind == "gpt"
                      else jbert.bert_pretrain_loss, opt,
                      amp_level=amp_level, amp_dtype="bfloat16",
                      recompute=recompute)
    args = [paddle.to_tensor(a) for a in batch()]
    losses = [float(step(*args)) for _ in range(steps)]
    states = {n: {k: np.array(st[k]) for k in ("moment1", "moment2")}
              for n, st in step._opt_states.items()}
    return losses, _np_params(ref, mod._PARAM_ORDER), states, port


def _port_steps(model, kind, steps, amp_level=None, recompute=False):
    step = TrainStep(model, MODELS[kind][3], AdamW(learning_rate=LR),
                     amp_level=amp_level, amp_dtype="bfloat16",
                     recompute=recompute)
    losses = [step(*MODELS[kind][4]()) for _ in range(steps)]
    return losses, step


def test_o2_remat_trajectory_bitwise_and_matches_reference():
    want, _, _, port = _reference_steps("gpt", "O2", 3)
    runs = {}
    for remat in (True, False):
        model = port(remat)
        losses, _ = _port_steps(model, "gpt", 3, amp_level="O2")
        runs[remat] = (losses, dict(model.named_parameters()))
    assert [x.item() for x in runs[True][0]] == [
        x.item() for x in runs[False][0]]
    _assert_equal(runs[True][1], runs[False][1])
    np.testing.assert_allclose([x.item() for x in runs[True][0]], want,
                               atol=ATOL_O2_LOSS, rtol=0)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_trainstep_recompute_bitwise_and_matches_reference(remat):
    want_l, want_p, want_s, port = _reference_steps("gpt", None, 2, remat,
                                                    recompute=True)
    got = {}
    for rc in (True, False):
        model = port(remat)
        losses, step = _port_steps(model, "gpt", 2, recompute=rc)
        got[rc] = (losses, dict(model.named_parameters()), step._opt_states)
    assert [x.item() for x in got[True][0]] == [
        x.item() for x in got[False][0]]
    _assert_equal(got[True][1], got[False][1])
    for n, st in got[True][2].items():
        _assert_equal(st, got[False][2][n])
    np.testing.assert_allclose([x.item() for x in got[True][0]], want_l,
                               atol=ATOL, rtol=0)
    for n, p in got[True][1].items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n], atol=ATOL,
                                   rtol=0, err_msg=n)
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(got[True][2][n][k].numpy(),
                                       want_s[n][k], atol=ATOL, rtol=0,
                                       err_msg=f"{n} {k}")


@pytest.mark.parametrize("remat,recompute_step,per_layer",
                         [(False, False, 1), (True, False, 2),
                          (False, True, 2), (True, True, 3)])
def test_forward_calls_per_layer(monkeypatch, remat, recompute_step,
                                 per_layer):
    """A remat layer runs its attention twice a step (forward, replay);
    inside TrainStep(recompute=True) three times: the step's replay runs
    the layer's region forward again, and that region replays."""
    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    model = GPT(gpt_tiny(**TINY, remat=remat), device="cpu")
    _port_steps(model, "gpt", 1, recompute=recompute_step)
    assert len(calls) == per_layer * TINY["num_layers"]


def _encoder(generator):
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        128, 2, 256, dropout=0.1, activation="gelu", device="cpu",
        generator=generator), 2)
    torch.manual_seed(0)
    for p in enc.parameters():
        torch.nn.init.normal_(p, std=0.05)
    return enc


def _dropout_run(use_recompute):
    gen = torch.Generator().manual_seed(7)
    enc = _encoder(gen)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 128, 128)).astype(np.float32)).requires_grad_()
    out = recompute(enc, x) if use_recompute else enc(x)
    (out * out).sum().backward()
    return (out.detach(), x.grad, {n: p.grad for n, p in
                                   enc.named_parameters()}, gen.get_state())


def _same_dropout_run(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(a[2][n], b[2][n]) for n in a[2])
            and torch.equal(a[3], b[3]))


def test_dropout_generator_replays_its_masks(monkeypatch):
    plain, checked = _dropout_run(False), _dropout_run(True)
    assert _same_dropout_run(checked, plain)
    # a replay that redraws: the masks no longer match the forward's
    monkeypatch.setattr(tcommon, "note_generator", lambda g: None)
    assert not _same_dropout_run(_dropout_run(True), plain)


def _bn_reference():
    paddle.seed(0)
    return jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1, bias_attr=False),
                          jnn.BatchNorm2D(4), jnn.ReLU(), jnn.Flatten(),
                          jnn.Linear(4 * 6 * 6, 1))


def _bn_port(params, buffers):
    m = tnn.Sequential(
        tnn.Conv2D(3, 4, 3, padding=1, bias_attr=False, device="cpu"),
        tnn.BatchNorm2D(4, device="cpu"), tnn.ReLU(), tnn.Flatten(),
        tnn.Linear(4 * 6 * 6, 1, device="cpu"))
    load_named_params(m, params)
    return load_named_buffers(m, buffers)


def _bn_data():
    rng = np.random.default_rng(12)
    return ((rng.standard_normal((8, 3, 6, 6)) + 0.5).astype(np.float32),
            rng.standard_normal((8, 1)).astype(np.float32))


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _named(pairs):
    return {n: np.array(t._data) for n, t in pairs}


def _bn_steps(weights, rc, steps=2):
    m = _bn_port(*weights)
    step = TrainStep(m, _mse, Momentum(learning_rate=0.05, momentum=0.9),
                     recompute=rc)
    for _ in range(steps):
        step(*_bn_data())
    return dict(m.named_parameters()), dict(m.named_buffers())


def test_batchnorm_running_stats_update_once(monkeypatch):
    ref = _bn_reference()
    weights = (_named(ref.named_parameters()), _named(ref.named_buffers()))
    step = JTrainStep(ref, _mse, jopt.Momentum(
        learning_rate=0.05, momentum=0.9, parameters=ref.parameters()),
        recompute=True)
    for _ in range(2):
        step(*[paddle.to_tensor(a) for a in _bn_data()])
    p_r, b_r = _bn_steps(weights, True)
    p_p, b_p = _bn_steps(weights, False)
    _assert_equal(p_r, p_p)
    _assert_equal(b_r, b_p)
    for n, b in ref.named_buffers():
        np.testing.assert_allclose(b_r[n].numpy(), np.asarray(b._data),
                                   atol=ATOL, rtol=ATOL, err_msg=n)
    # a replay that updates the running stats again
    monkeypatch.setattr(tnorm, "replaying", lambda: False)
    _, b_twice = _bn_steps(weights, True)
    assert not all(torch.equal(b_twice[n], b_p[n]) for n in b_p)


# -- fleet.utils.recompute: tests/test_recompute_util.py's four cases ------

def _linear(i, o, seed):
    m = tnn.Linear(i, o, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(
            rng.standard_normal((i, o)).astype(np.float32) * 0.3))
    return m


def test_fleet_recompute_grads_match_direct():
    fc1, fc2 = _linear(4, 8, 1), _linear(8, 4, 2)
    x = torch.from_numpy(RNG.standard_normal((5, 4)).astype(np.float32))

    def block(a):
        return fc2(TF.gelu(fc1(a)))

    got = []
    for run in (lambda a: recompute(block, a), block):
        xg = x.clone().requires_grad_()
        out = run(xg)
        out.sum().backward()
        got.append((out.detach(), xg.grad, fc1.weight.grad.clone()))
        fc1.weight.grad = None
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_fleet_recompute_rng_state_preserved_through_replay():
    gen = torch.Generator().manual_seed(7)
    drop, fc = tnn.Dropout(0.5, generator=gen), _linear(16, 16, 3)
    x = torch.from_numpy(RNG.standard_normal((4, 16)).astype(np.float32))
    got = []
    for run in (lambda a: recompute(lambda t: drop(fc(t)), a),
                lambda a: drop(fc(a))):
        gen.manual_seed(7)
        xg = x.clone().requires_grad_()
        out = run(xg)
        out.sum().backward()
        got.append((out.detach(), xg.grad))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    assert got[0][1].abs().sum() > 0
    # the default generator: the replay rewinds it as well
    torch.manual_seed(5)
    xg = x.clone().requires_grad_()
    out = recompute(lambda t: TF.dropout(fc(t), 0.5), xg)
    out.sum().backward()
    torch.manual_seed(5)
    xd = x.clone().requires_grad_()
    TF.dropout(fc(xd), 0.5).sum().backward()
    assert torch.equal(xg.grad, xd.grad)


def test_fleet_recompute_multi_output_and_pass_through():
    fc = _linear(3, 3, 4)
    x = torch.from_numpy(RNG.standard_normal((2, 3)).astype(np.float32))
    xg = x.clone().requires_grad_()
    a, b, c = recompute(lambda t: (fc(t), t * 2, t), xg)
    (a.sum() + b.sum() + (c * 3).sum()).backward()
    xd = x.clone().requires_grad_()
    (fc(xd).sum() + (xd * 2).sum() + (xd * 3).sum()).backward()
    assert torch.equal(xg.grad, xd.grad)


def test_fleet_recompute_trains():
    fc1, fc2 = _linear(4, 16, 5), _linear(16, 1, 6)
    params = list(fc1.parameters()) + list(fc2.parameters())
    opt = torch.optim.Adam(params, lr=0.05)
    x = torch.from_numpy(RNG.standard_normal((32, 4)).astype(np.float32))
    y = x @ torch.ones(4, 1)
    losses = []
    for _ in range(25):
        out = recompute(lambda a: fc2(TF.relu(fc1(a))), x)
        loss = ((out - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.2


def test_fleet_recompute_matches_reference():
    paddle.seed(0)
    j1, j2 = jnn.Linear(8, 16), jnn.Linear(16, 8)
    t1, t2 = (load_named_params(tnn.Linear(i, o, device="cpu"),
                                _named(j.named_parameters()))
              for j, (i, o) in ((j1, (8, 16)), (j2, (16, 8))))
    x = RNG.standard_normal((4, 8)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jrecompute(lambda a: j2(JF.gelu(j1(a))), jx)
    jout.sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = recompute(lambda a: t2(TF.gelu(t1(a))), tx)
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout._data),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               atol=ATOL, rtol=0)
    for (n, p), (_, q) in zip(t1.named_parameters(), j1.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(q.grad._data),
                                   atol=ATOL, rtol=0, err_msg=n)


class _Blocks(torch.nn.Module):
    def __init__(self, checked):
        super().__init__()
        self.fc1, self.fc2 = _linear(8, 32, 7), _linear(32, 8, 8)
        self.checked = checked

    def block(self, x):
        return self.fc2(TF.gelu(self.fc1(x)))

    def forward(self, x):
        return recompute(self.block, x) if self.checked else self.block(x)


def test_fleet_recompute_module_inside_o2_trainstep():
    """The replay runs after functional_call's O2 cast has ended: it must
    re-enter it and read the same bf16 weights, not the f32 masters."""
    x = RNG.standard_normal((3, 4, 8)).astype(np.float32)
    got = []
    for checked in (True, False):
        m = _Blocks(checked)
        step = TrainStep(m, lambda mm, a: (mm(a).float() ** 2).mean(),
                         Adam(learning_rate=1e-2), amp_level="O2")
        losses = [step(x).item() for _ in range(2)]
        got.append((losses, dict(m.named_parameters())))
    assert got[0][0] == got[1][0]
    _assert_equal(got[0][1], got[1][1])


@pytest.mark.parametrize("block,reentries", [("remat GPT", 0),
                                             ("fleet block", 1)])
def test_replay_reenters_the_o2_cast_only_for_fleet_recompute(
        monkeypatch, block, reentries):
    """A model's remat layer takes its cast weights as arguments, so its
    replay runs without re-entering the O2 substitution (a functional_call
    over the whole model a layer); fleet.utils.recompute's block reads
    module attributes and re-enters it once a replay."""
    calls = []
    plain = trc.substituted_call
    monkeypatch.setattr(trc, "substituted_call",
                        lambda *a: calls.append(1) or plain(*a))
    if block == "remat GPT":
        _port_steps(GPT(gpt_tiny(**TINY, remat=True), device="cpu"), "gpt",
                    1, amp_level="O2")
    else:
        step = TrainStep(_Blocks(True), lambda mm, a: (mm(a).float() ** 2)
                         .mean(), Adam(learning_rate=1e-2), amp_level="O2")
        step(RNG.standard_normal((3, 4, 8)).astype(np.float32))
    assert len(calls) == reentries


# -- the data-parallel steps at world size 1 over gloo ----------------------

def _dp_worker(rank, weights, init, path):
    torch.set_num_threads(1)
    init_process_group("cpu", rank=rank, world_size=1, init_method=init)
    try:
        mesh = tmesh({"dp": 1})
        out = {}
        for kind in ("replicated", "zero"):
            for rc in (False, True):
                m = _bn_port(*weights)
                opt = Momentum(learning_rate=0.05, momentum=0.9)
                step = (CompressedAllReduceTrainStep(
                    m, _mse, opt, mesh=mesh, compress_dtype="float32",
                    recompute=rc) if kind == "replicated" else
                    ShardedUpdateTrainStep(m, _mse, opt, mesh=mesh,
                                           wire_dtype="f32", chunk=8,
                                           recompute=rc))
                losses = [step(*_bn_data()) for _ in range(2)]
                out[kind, rc] = (losses, dict(m.named_parameters()),
                                 dict(m.named_buffers()))
        torch.save({k: (v[0], {n: t.detach() for n, t in v[1].items()},
                        v[2]) for k, v in out.items()}, f"{path}/out.pt")
    finally:
        dist.destroy_process_group()


def test_data_parallel_steps_recompute_bitwise(tmp_path):
    ref = _bn_reference()
    weights = (_named(ref.named_parameters()), _named(ref.named_buffers()))
    mp.spawn(_dp_worker, args=(weights, f"file://{tmp_path}/store",
                               str(tmp_path)), nprocs=1, join=True)
    out = torch.load(tmp_path / "out.pt", weights_only=False)
    for kind in ("replicated", "zero"):
        (l1, p1, b1), (l0, p0, b0) = out[kind, True], out[kind, False]
        assert [x.item() for x in l1] == [x.item() for x in l0]
        _assert_equal(p1, p0)
        _assert_equal(b1, b0)
        assert not all(torch.equal(p1[n], torch.from_numpy(weights[0][n]))
                       for n in p1)
