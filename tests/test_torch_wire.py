"""The port's wire codecs (paddle_tpu_torch/distributed/wire.py) and the
plain version of the row quantizer #9 (ops/cuda/ring_quant.py), bitwise
against the reference's numpy pair, its traced pair and its Pallas
``ring_quant_rows`` in interpret mode.  The CUDA kernel itself is held to
the plain codec on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed import wire as jwire
from paddle_tpu.ops.pallas import ring_quant as jrq
from paddle_tpu_torch.distributed import wire as twire
from paddle_tpu_torch.ops.cuda import ring_quant as trq

SHAPES = [(300, 256), (7, 128), (1024, 384), (5, 33), (4, 13)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jrq, "_INTERPRET", True)


def _rows(shape, seed=17):
    rows = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    rows[0] = 0.0                                   # an all-zero row
    return rows


def _ties(qmax):
    """Rows whose max is qmax (scale 1), so x / scale lands on .5 ties."""
    row = np.array([qmax, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -qmax,
                    qmax - 0.5, 0.0, -0.0], np.float32)
    return np.stack([row, row * 2.0])


@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("shape", SHAPES)
def test_codec_bitwise_numpy_traced_and_pallas(interpret, shape, wire):
    rows = _rows(shape)
    got = trq.ring_quant_rows(torch.from_numpy(rows), wire)
    q_np = jwire.quantize_rows(rows, wire)
    q_tr = jwire.quantize_rows_traced(jnp.asarray(rows), wire)
    q_pl = jrq.ring_quant_rows(jnp.asarray(rows), wire)
    for want in (q_np, q_tr, q_pl):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][0] == 1.0 and not got[0][0].any()   # zero row: scale 1


@pytest.mark.parametrize("wire,qmax", [("int8", 127.0), ("int4", 7.0)])
def test_ties_round_half_to_even(wire, qmax):
    rows = _ties(qmax)
    q, scale = trq.ring_quant_rows(torch.from_numpy(rows), wire)
    q_np, s_np = jwire.quantize_rows(rows, wire)
    np.testing.assert_array_equal(q.numpy(), q_np)
    np.testing.assert_array_equal(scale.numpy(), s_np)
    back = twire.dequantize_rows_torch((q, scale), wire, cols=rows.shape[1])
    want = np.clip(np.rint(rows[0]), -qmax, qmax)
    np.testing.assert_array_equal(back[0].numpy(), want)
    assert back[0, 1] == 0.0 and back[0, 2] == 2.0 and back[0, 3] == 2.0


@pytest.mark.parametrize("wire", ["f32", "bf16", "f16", "int8", "int4"])
@pytest.mark.parametrize("shape", [(6, 256), (5, 33), (2, 3, 13)])
def test_torch_pair_matches_traced_pair(wire, shape):
    rows = _rows(shape, seed=3) * 5
    got = twire.quantize_rows_torch(torch.from_numpy(rows), wire)
    want = jwire.quantize_rows_traced(jnp.asarray(rows), wire)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    cols = shape[-1]
    back = twire.dequantize_rows_torch(got, wire, cols=cols)
    ref = jwire.dequantize_rows_traced(want, wire, cols=cols)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref))
    assert back.shape == torch.Size(shape)


@pytest.mark.parametrize("cols", [13, 33, 1])
def test_odd_width_int4_decodes_with_cols(cols):
    rows = _rows((4, cols), seed=cols)
    packed, scale = twire.quantize_rows_torch(torch.from_numpy(rows), "int4")
    assert packed.dtype == torch.uint8 and packed.shape == (4, (cols + 1)
                                                            // 2)
    # the pad nibble is zero
    assert not (packed[:, -1] >> 4).any() or cols % 2 == 0
    back = twire.dequantize_rows_torch((packed, scale), "int4", cols=cols)
    want = jwire.dequantize_rows(jwire.quantize_rows(rows, "int4"), "int4",
                                 cols=cols)
    np.testing.assert_array_equal(back.numpy(), want)
    np.testing.assert_array_equal(
        twire.dequantize_rows([packed.numpy(), scale.numpy()], "int4",
                              cols=cols), want)


def test_nibble_pack_round_trips_every_value():
    q = torch.arange(-7, 8, dtype=torch.int8).repeat(2, 1)
    packed = twire.pack_nibbles_torch(q)
    assert int(twire.pack_nibbles_torch(torch.tensor([[-7, 0]],
                                                     dtype=torch.int8))) == 9
    np.testing.assert_array_equal(packed.numpy(),
                                  jwire._pack_nibbles(q.numpy(), np))
    np.testing.assert_array_equal(
        twire.unpack_nibbles_torch(packed, 15).numpy(), q.numpy())


def test_nan_row_gets_scale_one_and_inf_row_inf():
    rows = np.ones((3, 8), np.float32)
    rows[0, 2] = np.nan
    rows[1, 5] = np.inf
    for wire in ("int8", "int4"):
        _, scale = trq.ring_quant_rows(torch.from_numpy(rows), wire)
        _, s_np = jwire.quantize_rows(rows, wire)
        np.testing.assert_array_equal(scale.numpy(), s_np)
        assert scale[0] == 1.0 and scale[1] == np.inf


def test_numpy_pair_matches_reference():
    rows = _rows((9, 40), seed=8)
    for wire in ("f32", "int8", "int4"):
        got, want = twire.quantize_rows(rows, wire), jwire.quantize_rows(
            rows, wire)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(twire.dequantize_rows(got, wire, 40),
                                      jwire.dequantize_rows(want, wire, 40))
    b = twire.quantize_rows(rows, "bf16")[0]
    np.testing.assert_array_equal(
        b.float().numpy(),
        np.asarray(jwire.quantize_rows(rows, "bf16")[0], np.float32))


def test_normalize_wire_and_byte_accounting_match_reference():
    for name in ("float32", "bf16", "fp16", "s8", "i4", "INT8"):
        for known in (twire.WIRE_DTYPES, twire.COLLECTIVE_WIRE_DTYPES):
            try:
                want = jwire.normalize_wire(name, known=known)
            except ValueError:
                with pytest.raises(ValueError):
                    twire.normalize_wire(name, known=known)
                continue
            assert twire.normalize_wire(name, known=known) == want
    with pytest.raises(ValueError):
        twire.normalize_wire("int7")
    for n, w, row in [(1024, "f32", 0), (1024, "bf16", 0),
                      (1024, "int8", 256), (1000, "int4", 256),
                      (13, "int4", 13), (77, "int8", 0), (5, "f16", 0)]:
        assert twire.wire_nbytes(n, w, row=row) == jwire.wire_nbytes(
            n, w, row=row)


def test_quantizer_dispatch_rules():
    rows = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="cast wire"):
        trq.ring_quant_rows(rows, "bf16")
    with pytest.raises(ValueError, match="unsupported device"):
        trq.ring_quant_rows(rows.to("meta"), "int8")
    before = trq.launches
    trq.ring_quant_rows(rows, "int8")             # the CPU takes the plain
    assert trq.launches == before and trq.thread_launches() == 0
