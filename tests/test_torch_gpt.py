"""The port's GPT forward slice against the reference JAX GPT on the CPU.

gpt_tiny with hidden 128 and 2 heads gives head dim 64 and S = 128, which
keeps the reference on its flash path (the Pallas kernel in interpret
mode) and the port on its flash path (the plain version on the CPU).  A
single-device mesh is pinned for the reference, because its gpt_loss takes
the fused head only on one device.  Tolerance: 1e-4 absolute in f32.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_ce as jce
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import (GPT, gpt_loss, gpt_tiny,
                                     params_from_jax)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import fused_ce as tce

ATOL = 1e-4
TINY = dict(num_layers=2, hidden_size=128, num_heads=2, max_seq_len=128,
            remat=False)


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


@pytest.fixture(scope="module")
def models():
    ref = jgpt.GPT(jgpt.gpt_tiny(**TINY))
    np_params = {n: np.asarray(ref._parameters[n]._data)
                 for n in jgpt._PARAM_ORDER}
    port = GPT(gpt_tiny(**TINY), device="cpu").load_jax_params(np_params)
    return ref, np_params, port


def _ids(b=2, s=128, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_same_seed_gives_bit_identical_parameters(models):
    _, np_params, _ = models
    fresh = GPT(gpt_tiny(**TINY), device="cpu")
    assert tgpt._PARAM_ORDER == jgpt._PARAM_ORDER
    for n in jgpt._PARAM_ORDER:
        np.testing.assert_array_equal(getattr(fresh, n).detach().numpy(),
                                      np_params[n], err_msg=n)


def test_params_from_jax_checks_keys():
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({"wte": np.zeros((2, 2), np.float32)})


def test_logits_match_reference(models):
    ref, _, port = models
    ids = _ids()
    want = np.asarray(ref(paddle.to_tensor(ids))._data)
    before = tfa.launches
    with torch.no_grad():
        got = port(ids)
    assert tfa.launches == before        # the CPU takes the plain version
    assert got.shape == (2, 128, 256) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_gpt_loss_matches_reference(models, fused):
    ref, _, port = models
    ids = _ids(seed=1)
    jflags.set_flags({"gpt_fused_ce": fused})
    tflags.set_flags({"gpt_fused_ce": fused})
    want = float(jgpt.gpt_loss(ref, paddle.to_tensor(ids),
                               paddle.to_tensor(ids)))
    with torch.no_grad():                # scoring: no backward
        got = gpt_loss(port, ids, ids)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= ATOL


def test_fused_and_unfused_loss_agree(models):
    _, _, port = models
    ids = _ids(seed=2)
    with torch.no_grad():                # the fused head has no backward yet
        unfused = float(gpt_loss(port, ids, ids))
        tflags.set_flags({"gpt_fused_ce": True})
        assert abs(float(gpt_loss(port, ids, ids)) - unfused) <= ATOL


def test_flag_defaults_off_in_both():
    assert jflags.flag("gpt_fused_ce") is False
    assert tflags.flag("gpt_fused_ce") is False
    assert tflags.get_flags("FLAGS_gpt_fused_ce") == {
        "FLAGS_gpt_fused_ce": False}
    with pytest.raises(ValueError, match="unknown flag"):
        tflags.set_flags({"no_such_flag": 1})


def test_short_sequence_takes_dense_fallback(models):
    # S < 128: both packages use the dense attention (-1e30 clamp)
    ref, _, port = models
    ids = _ids(s=64, seed=3)
    want = np.asarray(ref(paddle.to_tensor(ids))._data)
    with torch.no_grad():
        got = port(ids)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_bf16_forward_runs_and_is_close(models):
    # AMP O2 stand-in: parameters cast to bf16, the loss in f32
    _, np_params, port = models
    half = GPT(gpt_tiny(**TINY), device="cpu").load_jax_params(np_params)
    half.to(torch.bfloat16)
    ids = _ids(seed=4)
    with torch.no_grad():
        assert half(ids).dtype == torch.bfloat16
        assert abs(float(gpt_loss(half, ids, ids))
                   - float(gpt_loss(port, ids, ids))) < 5e-2
