"""The port stands alone: no module of paddle_tpu_torch, and not
chip_smoke.py, imports jax or paddle_tpu; the card is the default device
and its absence raises instead of running on the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import GPT, gpt_tiny
from paddle_tpu_torch.ops.cuda import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    mods = [m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
    assert "paddle_tpu_torch.models.gpt" in mods
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'paddle_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_gpt_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert paddle_tpu_torch.get_device() == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        GPT(gpt_tiny(num_layers=1))
    with pytest.raises(RuntimeError, match="is_available"):
        tdevice.set_device("cuda")
    assert GPT(gpt_tiny(num_layers=1), device="cpu").wte.device.type == "cpu"


def test_set_device_round_trip():
    prev = paddle_tpu_torch.get_device()
    try:
        assert tdevice.set_device("cpu").type == "cpu"
        assert tdevice.resolve_device().type == "cpu"
    finally:
        tdevice._default = prev
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.resolve_device("meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_build_target_is_keyed_by_source_hash():
    for name in _build.KERNELS:
        t = _build._target(name)
        assert t.parent == _build.BUILD_DIR and t.name.startswith(name + "-")
        assert t == _build._target(name)            # stable
    assert (_build._target("flash_attention_fwd").name
            != _build._target("fused_ce_fwd").name)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_cuda():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
