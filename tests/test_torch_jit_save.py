"""``jit.save`` / ``jit.load`` / ``TranslatedLayer``, ``inference`` and
``framework/crypto`` of the port against the reference on the CPU.

- A reference MLP saved by the reference: its ``.pdparams`` loads in the
  port bitwise; the port's own ``save`` of those weights loads in the
  reference bitwise; the port's ``TranslatedLayer`` gives the reference's
  loaded outputs (1e-5) at any batch; the reference's ``.pdmodel``
  (StableHLO) is refused by name.
- ``gpt_tiny`` (1 layer, 2 heads of 64) and ResNet-18 (32x32) export with
  a dynamic batch and no warning; the loaded GPT equals the eager one at
  two batch sizes, and its graph holds the flash custom op.
- ``inference``: ``Config`` / ``create_predictor`` / ``Predictor`` and
  ``static.save_inference_model`` as the reference's tests drive them.
- ``crypto``: FIPS-197's known answers (AES-128, -192, -256), an
  encrypted ``.pdparams`` written by either package decrypted by the
  other, an encrypted artifact through ``Predictor`` bitwise, wrong keys,
  a missing key and a tampered byte raising as in the reference."""
import json
import warnings
import zipfile

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import jit as jjit
from paddle_tpu.framework import crypto as jcrypto
from paddle_tpu.framework import io as jio
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
from paddle_tpu.static import InputSpec as JSpec
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import inference, static
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.framework import crypto as tcrypto
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.models import GPT, gpt_tiny
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.vision.models import resnet18

ATOL = 1e-5
X = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    prev_dev, prev_mesh = tdevice.get_device(), get_mesh()
    tdevice.set_device("cpu")
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    tdevice._default = prev_dev
    set_mesh(prev_mesh)


def _jmlp():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))


def _tmlp():
    return tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


@pytest.fixture(scope="module")
def reference_saved(tmp_path_factory):
    """A reference MLP saved by the reference with a dynamic batch, and
    its loaded outputs at batch 3 and 5."""
    d = tmp_path_factory.mktemp("ref")
    m = _jmlp()
    p = str(d / "mlp")
    jjit.save(m, p, input_spec=[JSpec([None, 4], "float32")])
    loaded = jjit.load(p)
    x5 = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
    outs = [np.asarray(loaded(paddle.to_tensor(x))._data) for x in (X, x5)]
    return p, m, (X, x5), outs


def test_pdparams_cross_both_ways_bitwise(reference_saved, tmp_path):
    p, m, _, _ = reference_saved
    state = tpt.load(p + ".pdparams")
    want = {k: np.asarray(v._data) for k, v in m.state_dict().items()}
    assert list(state) == list(want)
    for k in want:
        assert _bits(state[k].detach().numpy()) == _bits(want[k]), k
    port = _tmlp()
    port.set_state_dict(state)
    q = str(tmp_path / "port")
    tjit.save(port, q)
    back = jio.load(q + ".pdparams")
    assert list(back) == list(want)
    for k in want:
        assert _bits(np.asarray(back[k]._data)) == _bits(want[k]), k


def test_translated_layer_gives_the_reference_outputs(reference_saved,
                                                      tmp_path):
    p, _, xs, outs = reference_saved
    port = _tmlp()
    port.set_state_dict(tpt.load(p + ".pdparams"))
    q = str(tmp_path / "port")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tjit.save(port, q, input_spec=[InputSpec([None, 4], "float32")])
    loaded = tjit.load(q)
    assert isinstance(loaded, tjit.TranslatedLayer)
    for x, want in zip(xs, outs):
        np.testing.assert_allclose(loaded(torch.from_numpy(x)).numpy(), want,
                                   atol=ATOL, rtol=0)
    assert torch.equal(loaded(torch.from_numpy(X)),
                       port(torch.from_numpy(X)))
    # the weights come from .pdparams: a changed file changes the output
    state = port.state_dict()
    state["0.weight"] = state["0.weight"] * 2
    tio.save(state, q + ".pdparams")
    assert not torch.equal(tjit.load(q)(torch.from_numpy(X)),
                           loaded(torch.from_numpy(X)))


def test_translated_layer_is_an_nn_layer(reference_saved, tmp_path):
    """A loaded artifact is an nn.Layer in both packages, and each of the
    13 Layer methods the reference's offers runs on the port's with the
    reference's outcome."""
    p, _, _, _ = reference_saved
    ref = jjit.load(p)
    port = _tmlp()
    port.set_state_dict(tpt.load(p + ".pdparams"))
    q = str(tmp_path / "port")
    tjit.save(port, q, input_spec=[InputSpec([None, 4], "float32")])
    loaded = tjit.load(q)
    assert isinstance(ref, jnn.Layer) and isinstance(loaded, tnn.Layer)
    for name in ("set_state_dict", "set_dict", "load_dict"):
        assert getattr(ref, name)({}) == ([], [])
        assert getattr(loaded, name)({}) == ([], [])
    assert ref.full_name() == loaded.full_name() == "translatedlayer"
    assert ref.sublayers() == loaded.sublayers() == []
    assert list(ref.named_sublayers()) == list(
        loaded.named_sublayers()) == []
    ref.register_forward_post_hook(lambda lay, i, o: o * 2)
    loaded.register_forward_post_hook(lambda lay, i, o: o * 2)
    np.testing.assert_allclose(
        loaded(torch.from_numpy(X)).numpy(),
        np.asarray(ref(paddle.to_tensor(X))._data), atol=2 * ATOL, rtol=0)
    np.testing.assert_allclose(loaded(torch.from_numpy(X)).numpy(),
                               2 * port(torch.from_numpy(X)).detach().numpy(),
                               atol=ATOL, rtol=0)
    ref.add_sublayer("extra", jnn.Linear(2, 2))
    loaded.add_sublayer("extra", tnn.Linear(2, 2))
    assert len(ref.sublayers()) == len(loaded.sublayers()) == 1
    w_ref, w_port = ref.create_parameter([2]), loaded.create_parameter([2])
    assert list(w_ref.shape) == list(w_port.shape) == [2]
    ref.add_parameter("w", w_ref)
    loaded.add_parameter("w", w_port)
    assert ref.clear_gradients() is None and loaded.clear_gradients() is None
    assert ref.astype("float32") is ref
    assert loaded.astype("float32") is loaded
    (pr, br), (pt, bt) = ref.functional_state(), loaded.functional_state()
    assert sorted(pr) == sorted(pt) == ["extra.bias", "extra.weight", "w"]
    assert br == bt == {}


def test_the_reference_pdmodel_is_refused_by_name(reference_saved):
    with pytest.raises(ValueError, match="StableHLO"):
        tjit.load(reference_saved[0])


def test_gpt_and_resnet18_export_with_a_dynamic_batch(tmp_path):
    gpt = GPT(gpt_tiny(num_layers=1, hidden_size=128, num_heads=2,
                       max_seq_len=128), device="cpu")
    net = resnet18(num_classes=10, device="cpu")
    net.eval()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tjit.save(gpt, str(tmp_path / "gpt"),
                  input_spec=[InputSpec([None, 128], "int64")])
        tjit.save(net, str(tmp_path / "r18"),
                  input_spec=[InputSpec([None, 3, 32, 32], "float32")])
    for name in ("gpt", "r18"):
        with zipfile.ZipFile(tmp_path / f"{name}.pdmodel") as z:
            meta = [n for n in z.namelist()
                    if n.endswith("paddle_tpu_torch.json")]
            assert json.loads(z.read(meta[0]))["dynamic"], name
    loaded = tjit.load(str(tmp_path / "gpt"))
    ops = {str(n.target) for n in loaded._program.graph.nodes}
    assert "paddle_tpu_torch.flash_fwd.default" in ops
    for b in (3, 1):
        ids = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, 128)))
        assert torch.equal(loaded(ids), gpt(ids).detach()), b


def _saved_port_mlp(tmp_path, **kw):
    port = _tmlp()
    port.set_state_dict({k: torch.from_numpy(np.asarray(v._data))
                         for k, v in _jmlp().state_dict().items()})
    prefix = str(tmp_path / "model")
    tjit.save(port, prefix, input_spec=[InputSpec([None, 4], "float32")],
              **kw)
    return port, prefix


def _predict(config, x):
    pred = inference.create_predictor(config)
    names = pred.get_input_names()
    assert len(names) == 1
    pred.get_input_handle(names[0]).copy_from_cpu(x)
    assert pred.run()
    return pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()


def test_predictor(tmp_path):
    port, prefix = _saved_port_mlp(tmp_path)
    want = port(torch.from_numpy(X)).detach().numpy()
    cfg = inference.Config(prefix)
    assert cfg.use_gpu()
    cfg.disable_gpu()
    np.testing.assert_array_equal(_predict(cfg, X), want)
    cfg = inference.Config(prefix + ".pdmodel")
    assert cfg.model_prefix == prefix
    cfg.enable_use_gpu(100, 0)
    cfg.disable_gpu()
    cfg.switch_ir_optim(True)
    cfg.enable_mkldnn()
    cfg.enable_tensorrt_engine(workspace_size=1 << 20)
    cfg.enable_profile()
    np.testing.assert_array_equal(_predict(cfg, X[:1]), want[:1])
    pred = inference.create_predictor(cfg)
    with pytest.raises(RuntimeError, match="not set"):
        pred.run()
    with pytest.raises(RuntimeError, match="no value"):
        inference.PredictorTensor("x").copy_to_cpu()


def test_static_save_and_load_inference_model(tmp_path):
    port = _tmlp()
    want = port(torch.from_numpy(X)).detach().numpy()
    prefix = str(tmp_path / "m")
    static.save_inference_model(prefix, [InputSpec([None, 4])], port)
    got = static.load_inference_model(prefix)(torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    with pytest.raises(TypeError, match="Layer"):
        static.save_inference_model(str(tmp_path / "x"), None, object())


@pytest.mark.parametrize("key,want", [
    ("000102030405060708090a0b0c0d0e0f", "69c4e0d86a7b0430d8cdb78070b4c55a"),
    ("000102030405060708090a0b0c0d0e0f1011121314151617",
     "dda97ca4864cdfe06eaf70a0ec0d7191"),
    ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
     "8ea2b7ca516745bfeafc49904b496089")])
def test_aes_fips197_known_answers(key, want):
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    got = tcrypto._aes_ecb_encrypt_block(bytes.fromhex(key), block)
    assert got.hex() == want
    assert jcrypto._aes_ecb_encrypt_block(bytes.fromhex(key), block) == got


@pytest.mark.parametrize("key", ["s3cret-passphrase", b"0123456789abcdef",
                                 bytes(range(32))])
def test_encrypted_pdparams_cross_both_ways(tmp_path, key):
    m = _jmlp()
    want = {k: np.asarray(v._data) for k, v in m.state_dict().items()}
    p = str(tmp_path / "ref")
    jjit.save(m, p, encrypt_key=key)
    with open(p + ".pdparams", "rb") as f:
        assert f.read(5) == b"PTAE1"
    state = tio.loads(tjit._read_artifact(p + ".pdparams", key))
    assert all(_bits(state[k].detach().numpy()) == _bits(want[k])
               for k in want)
    port = _tmlp()
    port.set_state_dict(state)
    q = str(tmp_path / "port")
    tjit.save(port, q, encrypt_key=key)
    back = jio.loads(jjit._read_artifact(q + ".pdparams", key))
    assert all(_bits(np.asarray(back[k]._data)) == _bits(want[k])
               for k in want)
    assert tjit._cipher_for(key)[1] == jjit._cipher_for(key)[1]


def test_encrypted_artifact_through_the_predictor(tmp_path):
    key = "s3cret-passphrase"
    port, prefix = _saved_port_mlp(tmp_path, encrypt_key=key)
    for ext in (".pdparams", ".pdmodel"):
        with open(prefix + ext, "rb") as f:
            assert f.read(5) == b"PTAE1", ext
    want = port(torch.from_numpy(X)).detach().numpy()
    cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdparams")
    cfg.set_cipher_key(key)
    cfg.disable_gpu()
    np.testing.assert_array_equal(_predict(cfg, X), want)
    np.testing.assert_array_equal(
        tjit.load(prefix, decrypt_key=key)(torch.from_numpy(X)).numpy(),
        want)
    with pytest.raises(ValueError, match="encrypted"):
        tjit.load(prefix)
    with pytest.raises(ValueError, match="authentication failed"):
        tjit.load(prefix, decrypt_key="wrong-key")
    with open(prefix + ".pdparams", "rb") as f:
        blob = bytearray(f.read())
    blob[40] ^= 0xFF
    with open(prefix + ".pdparams", "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="authentication failed"):
        tjit.load(prefix, decrypt_key=key)
