"""``paddle.inference``: the deployment facade (port of
paddle_tpu/inference/__init__.py).

``Config`` names ``jit.save``'s artifact, ``create_predictor`` loads it
(``jit.load``) and ``Predictor`` runs it through named input and output
handles.  The Predictor runs on the card unless ``Config.disable_gpu()``
is called (the reference records ``enable_use_gpu`` and leaves the device
to XLA); the artifact is moved to that device when it was captured on the
other (``jit.load``).  The reference's MKLDNN / TensorRT / IR knobs are
accepted and recorded.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.profiler import RecordEvent

__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor"]


def _prefix(prog_file: Optional[str]) -> str:
    p = prog_file or ""
    return p[: -len(".pdmodel")] if p.endswith(".pdmodel") else p


class Config:
    """``paddle_infer.Config`` (reference ``:23``): the model's path
    prefix (or its ``.pdmodel`` path), the device and the key."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None, decrypt_key=None):
        self.model_prefix = _prefix(prog_file)
        self._use_gpu = True
        self._device_id = 0
        self._enable_profile = False
        self._flags: Dict[str, object] = {}
        self._decrypt_key = decrypt_key

    def set_cipher_key(self, key):
        """The key of a model saved with ``jit.save(encrypt_key=...)``."""
        self._decrypt_key = key

    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        self.model_prefix = _prefix(prog_file)

    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self) -> bool:
        return self._use_gpu

    def device(self) -> torch.device:
        return torch.device("cuda", self._device_id) if self._use_gpu \
            else torch.device("cpu")

    def enable_profile(self):
        self._enable_profile = True

    def switch_ir_optim(self, on: bool = True):
        self._flags["ir_optim"] = on

    def enable_mkldnn(self):
        self._flags["mkldnn"] = True

    def enable_tensorrt_engine(self, **kw):
        self._flags["tensorrt"] = kw

    def model_dir(self):
        return self.model_prefix


class PredictorTensor:
    """``paddle_infer.Tensor`` (reference ``:76``): a named handle.  An
    input holds the host array it was given; an output holds the device
    tensor, which ``copy_to_cpu`` reads back (bf16 as float32: numpy has
    no bf16)."""

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[np.ndarray] = None
        self._tensor: Optional[torch.Tensor] = None

    def copy_from_cpu(self, arr):
        self._value = np.asarray(arr)

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def copy_to_cpu(self) -> np.ndarray:
        if self._tensor is not None:
            t = self._tensor.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy()
        if self._value is None:
            raise RuntimeError(f"tensor {self.name} has no value yet — "
                               "call Predictor.run() first")
        return self._value


class Predictor:
    """``paddle_infer.Predictor`` over a ``TranslatedLayer`` (reference
    ``:97``)."""

    def __init__(self, config: Config):
        from paddle_tpu_torch import jit
        self.config = config
        self._layer = jit.load(config.model_prefix,
                               decrypt_key=config._decrypt_key,
                               device=config.device())
        n_in = max(1, len(self._layer._meta["inputs"]))
        self._inputs = {f"input_{i}": PredictorTensor(f"input_{i}")
                        for i in range(n_in)}
        self._outputs: Dict[str, PredictorTensor] = {}

    def get_input_names(self) -> List[str]:
        return list(self._inputs)

    def get_input_handle(self, name: str) -> PredictorTensor:
        return self._inputs[name]

    def run(self):
        args = []
        for name, h in self._inputs.items():
            if h._value is None:
                raise RuntimeError(f"input {name} not set")
            args.append(torch.as_tensor(h._value, device=self._layer.device))
        span = RecordEvent("Predictor.run") \
            if self.config._enable_profile else contextlib.nullcontext()
        with torch.no_grad(), span:
            out = self._layer(*args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = {}
        for i, o in enumerate(outs):
            t = PredictorTensor(f"output_{i}")
            t._tensor = o
            self._outputs[t.name] = t
        return True

    def get_output_names(self) -> List[str]:
        return list(self._outputs)

    def get_output_handle(self, name: str) -> PredictorTensor:
        return self._outputs[name]


def create_predictor(config: Config) -> Predictor:
    """``paddle.inference.create_predictor`` (reference ``:145``)."""
    return Predictor(config)
