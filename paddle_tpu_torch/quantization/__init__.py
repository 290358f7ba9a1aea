"""Quantization: QAT fake-quant and post-training int8 inference (port of
paddle_tpu/quantization/__init__.py).

- The fake quantizers round to the 8-bit grid in the forward and pass the
  gradient straight through (``x + (q(x) - x).detach()``), as the
  reference's ``x + stop_gradient(q(x) - x)``.
- ``Int8InferenceLinear`` / ``Int8InferenceConv2D`` run the int8 x int8
  -> int32 product that the reference runs through XLA (``dot_general`` /
  ``conv_general_dilated`` with an int32 accumulator; no Pallas kernel):
  here ``torch._int_mm``, for the convolution over an im2col of the
  quantized activation (``F.unfold``), group by group.  ``_int_mm``'s
  shape rules on the card (more than 16 rows, K and N multiples of 8) are
  met by zero padding, which is exact: a zero code adds nothing (ResNet's
  stem has K = 147).  The
  same route runs on the CPU, so the int32 accumulators are the
  reference's bitwise.
- Activations are quantized per tensor by abs-max (``_quant_act``), the
  weights per output channel (``_quantize_weight``, numpy, the
  reference's code).  The codes, scales and bias of an int8 layer are
  plain tensor attributes, outside ``state_dict`` as in the reference;
  they move with ``.to(device)`` and a capture takes them as constants.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.nn.layer.layers import Layer

__all__ = ["fake_quantize_dequantize_abs_max",
           "fake_channel_wise_quantize_dequantize_abs_max",
           "MovingAverageAbsMaxObserver", "QuantizedLinear",
           "ImperativeQuantAware", "quant_post_weights", "dequant_weights",
           "Int8InferenceLinear", "Int8InferenceConv2D",
           "convert_to_int8_inference"]


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _quant_act(a):
    """Per-tensor abs-max activation codes (reference ``:43``): (int8
    codes, f32 scale) with scale = max(max|a|, 1e-8) / 127, the codes
    rounded half to even and clipped to +-127."""
    af = a.float()
    s_x = torch.clamp_min(af.abs().amax(), 1e-8) / 127.0
    return torch.clamp(torch.round(af / s_x), -127, 127).to(torch.int8), s_x


def fake_quantize_dequantize_abs_max(x, bits: int = 8, name=None):
    """Reference ``:50``: scale = max|x|, straight-through gradient."""
    qm = _qmax(bits)
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-8)
    q = torch.round(x.detach() / scale * qm) / qm * scale
    return x + (q - x).detach()


def fake_channel_wise_quantize_dequantize_abs_max(x, bits: int = 8,
                                                  quant_axis: int = 0,
                                                  name=None):
    """Reference ``:63``: one scale per slice along ``quant_axis``.  The
    axis is taken as it is, as the reference takes it: a negative one
    matches no axis, so the whole tensor shares one scale."""
    qm = _qmax(bits)
    axes = tuple(i for i in range(x.ndim) if i != quant_axis)
    xd = x.detach()
    scale = torch.clamp_min(xd.abs().amax(dim=axes, keepdim=True), 1e-8)
    q = torch.round(xd / scale * qm) / qm * scale
    return x + (q - x).detach()


class MovingAverageAbsMaxObserver:
    """The moving-average abs-max state machine (rate 0.9) of activation
    scales (reference ``:80``); ``update`` reads max|x| back to the
    host."""

    def __init__(self, rate: float = 0.9):
        self.rate = rate
        self.scale: Optional[float] = None

    def update(self, x) -> float:
        cur = float(torch.as_tensor(x).detach().abs().max())
        self.scale = cur if self.scale is None else \
            self.rate * self.scale + (1 - self.rate) * cur
        return max(self.scale, 1e-8)

    def quantize(self, x, bits: int = 8):
        qm = _qmax(bits)
        scale = self.update(x)
        xd = x.detach()
        q = torch.clamp(torch.round(xd / scale * qm), -qm, qm) / qm * scale
        return x + (q - x).detach()


class QuantizedLinear(Layer):
    """QAT linear (reference ``:110``): channel-wise fake-quant weight,
    moving-average fake-quant input, then the dense product."""

    def __init__(self, linear, weight_bits: int = 8,
                 activation_bits: int = 8):
        super().__init__()
        self.weight = linear.weight
        self.bias = getattr(linear, "bias", None)
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self._observer = MovingAverageAbsMaxObserver()

    def forward(self, x):
        import paddle_tpu_torch.nn.functional as F
        xq = self._observer.quantize(x, self.activation_bits)
        wq = fake_channel_wise_quantize_dequantize_abs_max(
            self.weight, self.weight_bits, quant_axis=1)
        return F.linear(xq, wq, self.bias)


class ImperativeQuantAware:
    """Swaps every ``Linear`` for a ``QuantizedLinear`` in place (reference
    ``:130``)."""

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    def quantize(self, model: Layer) -> Layer:
        from paddle_tpu_torch.nn.layer.common import Linear
        for name, child in list(model._modules.items()):
            if isinstance(child, Linear):
                setattr(model, name, QuantizedLinear(
                    child, self.weight_bits, self.activation_bits))
            elif child is not None:
                self.quantize(child)
        return model


def quant_post_weights(model: Layer, bits: int = 8) -> Dict[str, dict]:
    """Per-channel int8 codes and scales of every 2-D ``*weight``
    (reference ``:153``): {name: {"int": int8 array, "scale": (out,)}}."""
    out = {}
    for name, p in model.named_parameters():
        if p.ndim != 2 or not name.endswith("weight"):
            continue
        q, scale = _quantize_weight(_host(p), bits)
        out[name] = {"int": q, "scale": scale}
    return out


def dequant_weights(packed: Dict[str, dict]) -> Dict[str, np.ndarray]:
    return {n: d["int"].astype(np.float32) * d["scale"]
            for n, d in packed.items()}


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm(a_q, w_q):
    """int32 (M, N) = a_q (M, K) int8 @ w_q (K, N) int8 through
    ``torch._int_mm``, zero-padded to K and N multiples of 8 and, unless M
    is known to exceed 16 (under a capture with a dynamic batch, known
    from the dim's range), 16 more rows."""
    from torch.fx.experimental.symbolic_shapes import statically_known_true
    m, k = a_q.shape
    n = w_q.shape[1]
    kp, np_ = _pad_to(k, 8), _pad_to(n, 8)
    rows = 0 if statically_known_true(m > 16) else 16
    if rows or kp != k:
        a_q = torch.nn.functional.pad(a_q, (0, kp - k, 0, rows))
    if (kp, np_) != (k, n):
        w_q = torch.nn.functional.pad(w_q, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a_q, w_q)[:m, :n]


class _Int8Layer(Layer):
    """The int8 layers' tensors (codes, scales, bias) as plain attributes
    that ``.to`` / ``.cuda`` / ``.cpu`` move and no dtype cast changes
    (the epilogue is f32, as the reference's)."""

    _TENSORS = ("_w_q", "_w_scale", "_bias")

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for n in self._TENSORS:
            t = getattr(self, n)
            if t is not None:
                object.__setattr__(self, n, fn(t).to(t.dtype))
        return self

    def _set(self, w_int8, w_scale, bias, device):
        object.__setattr__(self, "_w_q", torch.as_tensor(
            np.asarray(w_int8, np.int8), device=device))
        object.__setattr__(self, "_w_scale", torch.as_tensor(
            np.asarray(w_scale, np.float32), device=device))
        object.__setattr__(self, "_bias", None if bias is None else
                           torch.as_tensor(np.asarray(bias, np.float32),
                                           device=device))

    @staticmethod
    def _epilogue(acc, s_x, ws, b, dtype, shape):
        y = acc.float() * (s_x * ws).reshape(shape)
        if b is not None:
            y = y + b.reshape(shape)
        return y if dtype == torch.float32 else y.to(dtype)


class Int8InferenceLinear(_Int8Layer):
    """Linear run as int8 x int8 -> int32 (reference ``:174``): weights
    (in, out) per-output-channel codes, the activation per tensor."""

    def __init__(self, w_int8, w_scale, bias=None, device=None):
        super().__init__()
        from paddle_tpu_torch.device import resolve_device
        self._set(w_int8, w_scale, bias, resolve_device(device))

    def accumulate(self, x):
        """(the int32 accumulator (..., out), the activation's scale)."""
        a_q, s_x = _quant_act(x)
        acc = _int_mm(a_q.reshape(-1, a_q.shape[-1]), self._w_q)
        return acc.reshape(*x.shape[:-1], acc.shape[-1]), s_x

    def forward(self, x):
        acc, s_x = self.accumulate(x)
        return self._epilogue(acc, s_x, self._w_scale, self._bias, x.dtype,
                              (-1,))


class Int8InferenceConv2D(_Int8Layer):
    """NCHW Conv2D run as int8 x int8 -> int32 (reference ``:209``):
    weights (O, I / groups, kh, kw) per-output-channel codes, the
    activation per tensor; im2col of the codes, then one ``_int_mm`` a
    group."""

    def __init__(self, w_int8, w_scale, bias=None, stride=1, padding=0,
                 dilation=1, groups: int = 1, device=None):
        super().__init__()
        from paddle_tpu_torch.device import resolve_device
        from paddle_tpu_torch.nn.functional.conv import _tuplify
        self._set(w_int8, w_scale, bias, resolve_device(device))
        self._stride = _tuplify(stride, 2)
        self._padding = padding
        self._dilation = _tuplify(dilation, 2)
        self._groups = int(groups)

    def accumulate(self, x):
        """(the int32 accumulator (N, O, Ho, Wo), the activation's
        scale)."""
        from paddle_tpu_torch.nn.functional.conv import (flat_pad,
                                                         resolve_pads)
        a_q, s_x = _quant_act(x)
        o, ipg, kh, kw = self._w_q.shape
        n, _, h, w = x.shape
        pads = resolve_pads(self._padding, (h, w), (kh, kw), self._stride,
                            self._dilation)
        # the codes as exact small floats for the im2col (half on the
        # card, where unfold takes no int8)
        ft = torch.float16 if x.device.type == "cuda" else torch.float32
        a = torch.nn.functional.pad(a_q.to(ft), flat_pad(pads))
        ho = (a.shape[2] - self._dilation[0] * (kh - 1) - 1) \
            // self._stride[0] + 1
        wo = (a.shape[3] - self._dilation[1] * (kw - 1) - 1) \
            // self._stride[1] + 1
        g, opg = self._groups, o // self._groups
        accs = []
        for gi in range(g):
            cols = torch.nn.functional.unfold(
                a[:, gi * ipg:(gi + 1) * ipg], (kh, kw),
                dilation=self._dilation, stride=self._stride)
            cols = cols.transpose(1, 2).reshape(n * ho * wo, ipg * kh * kw)
            wg = self._w_q[gi * opg:(gi + 1) * opg].reshape(opg, -1).T
            accs.append(_int_mm(cols.to(torch.int8), wg.contiguous()))
        acc = accs[0] if g == 1 else torch.cat(accs, dim=1)
        return acc.reshape(n, ho, wo, o).permute(0, 3, 1, 2), s_x

    def forward(self, x):
        acc, s_x = self.accumulate(x)
        return self._epilogue(acc, s_x, self._w_scale, self._bias, x.dtype,
                              (1, -1, 1, 1))


def _quantize_weight(w: np.ndarray, bits: int = 8, out_axis: int = 1):
    """Per-out-channel symmetric int8 codes and f32 scales (reference
    ``:257``, the same numpy code); ``out_axis`` 1 for Linear's (in, out),
    0 for Conv2D's (O, I, kh, kw)."""
    qm = _qmax(bits)
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != out_axis)
    scale = np.maximum(np.abs(w).max(axis=reduce_axes), 1e-8)
    shape = [1] * w.ndim
    shape[out_axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape) * qm), -qm, qm) \
        .astype(np.int8)
    return q, (scale / qm).astype(np.float32)


def _bias_of(layer):
    b = getattr(layer, "bias", None)
    return None if b is None else _host(b)


def _int8_of(linear) -> Int8InferenceLinear:
    q, scale = _quantize_weight(_host(linear.weight))
    return Int8InferenceLinear(q, scale, _bias_of(linear),
                               device=linear.weight.device)


def _int8_of_conv(conv) -> Int8InferenceConv2D:
    q, scale = _quantize_weight(_host(conv.weight), out_axis=0)
    return Int8InferenceConv2D(q, scale, _bias_of(conv), stride=conv._stride,
                               padding=conv._padding,
                               dilation=conv._dilation, groups=conv._groups,
                               device=conv.weight.device)


def convert_to_int8_inference(model: Layer,
                              convert_conv: bool = True) -> Layer:
    """Swap every ``Linear`` and (by default) every NCHW ``Conv2D`` for its
    int8 counterpart, in place (reference ``:291``); exact types only.  A
    bare Linear or Conv2D is converted and returned."""
    from paddle_tpu_torch.nn.layer.common import Linear
    from paddle_tpu_torch.nn.layer.conv import Conv2D

    def convert(m):
        if type(m) is Linear:
            return _int8_of(m)
        if convert_conv and type(m) is Conv2D and m._data_format == "NCHW":
            return _int8_of_conv(m)
        return None

    new = convert(model)
    if new is not None:
        return new
    for name, child in list(model._modules.items()):
        if child is None:
            continue
        new = convert(child)
        if new is not None:
            setattr(model, name, new)
        else:
            convert_to_int8_inference(child, convert_conv=convert_conv)
    return model
