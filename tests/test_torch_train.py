"""The port's training slice against the reference JAX TrainStep on the CPU.

The TINY config (2 layers, hidden 128, 2 heads, S = 128) keeps both
packages on their flash path: the reference's Pallas kernels in interpret
mode, the port's plain versions on the CPU.  A single-device mesh is
pinned for the reference.  The same numpy draws give both models their
parameters and both steps their ids.

Tolerances: f32 gradients, losses, parameters and moments 1e-4 absolute
(the two sum in different orders); the beta pows exactly (the same f32
products); AMP O2 bf16 losses 2e-2 (bf16 rounding at different places).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_ce as jce
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPT, gpt_loss, gpt_tiny,
                                     opt_states_from_jax)
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import fused_ce as tce
from paddle_tpu_torch.optimizer import Adam, AdamW

ATOL = 1e-4
ATOL_O2_LOSS = 2e-2
LR = 1e-4                 # bench.py's AdamW rate
STEPS = 3
TINY = dict(num_layers=2, hidden_size=128, num_heads=2, max_seq_len=128,
            remat=False)
KEYS = ("moment1", "moment2", "beta1_pow", "beta2_pow")


@pytest.fixture(autouse=True)
def _reference_env():
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfa._INTERPRET = jce._INTERPRET = True
    yield
    jfa._INTERPRET = jce._INTERPRET = False
    jflags.set_flags({"gpt_fused_ce": False})
    tflags.set_flags({"gpt_fused_ce": False})
    set_mesh(prev)


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (2, 128)).astype(
        np.int32)


def _np_params(model):
    return {n: np.array(model._parameters[n]._data)
            for n in jgpt._PARAM_ORDER}


def _port(np_params):
    return GPT(gpt_tiny(**TINY), device="cpu").load_jax_params(np_params)


def _reference_run(amp_level):
    """STEPS reference TrainStep steps from the seed on one fixed batch,
    as bench.py trains: the initial parameters, then (loss, parameters,
    optimizer state) after each."""
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfa._INTERPRET = True
    try:
        ref = jgpt.GPT(jgpt.gpt_tiny(**TINY))
        init = _np_params(ref)
        opt = jopt.AdamW(learning_rate=LR, parameters=ref.parameters())
        step = JTrainStep(ref, jgpt.gpt_loss, opt, amp_level=amp_level,
                          amp_dtype="bfloat16")
        after = []
        ids = paddle.to_tensor(_ids(10))
        for _ in range(STEPS):
            loss = float(step(ids, ids))
            states = {n: {k: np.array(a) for k, a in st.items()}
                      for n, st in step._opt_states.items()}
            after.append((loss, _np_params(ref), states))
        return init, after
    finally:
        jfa._INTERPRET = False
        set_mesh(prev)


@pytest.fixture(scope="module")
def ref_f32():
    return _reference_run(None)


@pytest.fixture(scope="module")
def ref_o2():
    return _reference_run("O2")


def _port_run(init, amp_level=None, steps=STEPS):
    model = _port(init)
    step = TrainStep(model, gpt_loss, AdamW(learning_rate=LR),
                     amp_level=amp_level, amp_dtype="bfloat16")
    losses = [float(step(_ids(10), _ids(10))) for _ in range(steps)]
    return model, step, losses


def _assert_params(model, want):
    for n in jgpt._PARAM_ORDER:
        np.testing.assert_allclose(getattr(model, n).detach().numpy(),
                                   want[n], atol=ATOL, rtol=0, err_msg=n)


def test_parameter_gradients_match_reference_tape():
    ref = jgpt.GPT(jgpt.gpt_tiny(**TINY))
    port = _port(_np_params(ref))
    ids = _ids(0)
    want = jgpt.gpt_loss(ref, paddle.to_tensor(ids), paddle.to_tensor(ids))
    want.backward()
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    got = gpt_loss(port, ids, ids)
    got.backward()
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == before
    assert abs(got.item() - float(want)) <= ATOL
    for n in jgpt._PARAM_ORDER:
        g = getattr(port, n).grad
        assert g is not None and g.shape == getattr(port, n).shape, n
        np.testing.assert_allclose(
            g.numpy(), np.asarray(ref._parameters[n].grad._data),
            atol=ATOL, rtol=0, err_msg=n)


def test_short_sequence_gradients_take_dense_fallback():
    # S < 128: both packages differentiate the dense attention
    ref = jgpt.GPT(jgpt.gpt_tiny(**TINY))
    port = _port(_np_params(ref))
    ids = _ids(1)[:, :64]
    jgpt.gpt_loss(ref, paddle.to_tensor(ids), paddle.to_tensor(ids)
                  ).backward()
    gpt_loss(port, ids, ids).backward()
    for n in ("wte", "qkv_w", "prj_w"):
        np.testing.assert_allclose(
            getattr(port, n).grad.numpy(),
            np.asarray(ref._parameters[n].grad._data), atol=ATOL, rtol=0,
            err_msg=n)


def test_f32_train_steps_match_reference(ref_f32):
    init, after = ref_f32
    model, step, losses = _port_run(init)
    np.testing.assert_allclose(losses, [a[0] for a in after], atol=ATOL,
                               rtol=0)
    assert losses[-1] < losses[0]
    _, want_params, want_states = after[-1]
    _assert_params(model, want_params)
    for n in jgpt._PARAM_ORDER:
        # each parameter moved ~3e-4; its move agrees to 1 % of that
        moved = np.abs(want_params[n] - init[n]).max()
        err = np.abs(getattr(model, n).detach().numpy() - want_params[n])
        assert err.max() <= 1e-2 * moved, n
    assert set(step._opt_states) == set(want_states)
    for n, st in step._opt_states.items():
        assert set(st) == set(KEYS)
        assert all(t.dtype == torch.float32 for t in st.values())
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(st[k].numpy(), want_states[n][k],
                                       atol=ATOL, rtol=0, err_msg=f"{n} {k}")
        for k in ("beta1_pow", "beta2_pow"):
            assert st[k].numpy() == want_states[n][k], (n, k)
    assert step.optimizer._global_step == STEPS


def test_o2_bf16_losses_match_reference(ref_o2):
    init, after = ref_o2
    model, _, losses = _port_run(init, amp_level="O2")
    np.testing.assert_allclose(losses, [a[0] for a in after],
                               atol=ATOL_O2_LOSS, rtol=0)
    # the masters stay f32 and move
    assert model.wte.dtype == torch.float32
    assert not np.array_equal(model.wte.detach().numpy(), init["wte"])


def test_continues_from_reference_state(ref_f32):
    # load the reference's parameters and AdamW state after step 2 and
    # take step 3 in the port
    _, after = ref_f32
    _, params2, states2 = after[STEPS - 2]
    loss3, params3, states3 = after[STEPS - 1]
    model = _port(params2)
    opt = AdamW(learning_rate=LR)
    opt._global_step = STEPS - 1
    step = TrainStep(model, gpt_loss, opt)
    step.set_opt_states(opt_states_from_jax(states2))
    ids = _ids(10)
    assert abs(float(step(ids, ids)) - loss3) <= ATOL
    _assert_params(model, params3)
    for n, st in step._opt_states.items():
        np.testing.assert_allclose(st["moment2"].numpy(),
                                   states3[n]["moment2"], atol=ATOL, rtol=0)
        assert st["beta1_pow"].numpy() == states3[n]["beta1_pow"]


def test_opt_states_from_jax_checks_keys():
    with pytest.raises(ValueError, match="expected"):
        opt_states_from_jax({"wte": {"moment1": np.zeros(2, np.float32)}})


def test_adam_update_matches_reference_rule():
    # one Adam (coupled L2) and one AdamW update of a lone tensor, against
    # the reference's functional_update on the same numpy values
    rng = np.random.default_rng(5)
    p, g = (rng.standard_normal((4, 8)).astype(np.float32) for _ in "pg")
    for jcls, tcls, kw in [(jopt.Adam, Adam, {"weight_decay": 0.1}),
                           (jopt.AdamW, AdamW, {"weight_decay": 0.05})]:
        jo, to = jcls(learning_rate=0.01, **kw), tcls(learning_rate=0.01,
                                                      **kw)
        jp, js = {"w": jax.numpy.asarray(p)}, None
        tp, ts = {"w": torch.from_numpy(p)}, None
        js = jo.functional_init_states(jp)
        ts = to.functional_init_states(tp)
        for _ in range(2):
            jp, js = jo.functional_update(jp, {"w": jax.numpy.asarray(g)},
                                          js, lr=np.float32(0.01))
            tp, ts = to.functional_update(tp, {"w": torch.from_numpy(g)},
                                          ts, lr=torch.tensor(0.01))
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   atol=1e-6, rtol=0)
        for k in KEYS:
            np.testing.assert_allclose(ts["w"][k].numpy(),
                                       np.asarray(js["w"][k]), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("what", ["fused_ce", "use_fused", "grad_clip",
                                  "accumulate_steps", "amp_o1", "recompute",
                                  "lr_scheduler", "decay_fun"])
def test_next_slice_options_raise(what):
    model = GPT(gpt_tiny(**TINY), device="cpu")
    ids = _ids(2)
    with pytest.raises(NotImplementedError):
        if what == "fused_ce":
            tflags.set_flags({"gpt_fused_ce": True})
            TrainStep(model, gpt_loss, AdamW(learning_rate=LR))(ids, ids)
        elif what == "use_fused":
            AdamW(learning_rate=LR, use_fused=True)
        elif what == "grad_clip":
            AdamW(learning_rate=LR, grad_clip=object())
        elif what == "accumulate_steps":
            TrainStep(model, gpt_loss, AdamW(), accumulate_steps=2)
        elif what == "amp_o1":
            TrainStep(model, gpt_loss, AdamW(), amp_level="O1")
        elif what == "recompute":
            TrainStep(model, gpt_loss, AdamW(), recompute=True)
        elif what == "lr_scheduler":
            AdamW(learning_rate=lambda: 1e-4)
        else:
            AdamW(apply_decay_param_fun=lambda n: True)


def test_cpu_training_counts_no_launch():
    model = GPT(gpt_tiny(**TINY), device="cpu")
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv,
              tce.launches)
    step = TrainStep(model, gpt_loss, AdamW(learning_rate=LR),
                     amp_level="O2")
    loss = step(_ids(3), _ids(3))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert not loss.requires_grad
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv,
            tce.launches) == before
