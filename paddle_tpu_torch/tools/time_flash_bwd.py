"""Time the bf16 flash-attention backward on the card at the shapes the main
paths give it: GPT-2 345M's layer (B*H = 8*16, S = 1024, causal) at head
dims 64 and 128, and BERT-base's layer (B*H = 128*12, S = 128) with the
padded batch's (128, 1, 1, 128) f32 padding bias, with the learned-bias
encoder's (1, 12, 128, 128) bf16 bias, and without a mask.

    PYTHONPATH=. python paddle_tpu_torch/tools/time_flash_bwd.py [--reps 20]

Prints the card's name and power limit (nvidia-smi), then one JSON line:
for each shape the mean ms of one call of the dq kernel
(``flash_attention._launch_dq``), of the dk/dv kernel (``_launch_dkv``)
and of ``_delta`` (delta = rowsum(do * o), the backward's preprocessing in
PyTorch) by CUDA events, the calls queued behind a sleeping kernel; the
device ms of the kernels of one dq + dk/dv pair by name (torch.profiler
over 5 pairs); the ms of the library's whole backward
(``torch.autograd.grad`` of ``scaled_dot_product_attention`` on the same
inputs, its own preprocessing included), the yardstick; and the least
time the card could take (the larger of the bytes at 3.35 TB/s and the
operations at 989 TFLOP/s) for dq (3 products), dk/dv (4) and the whole
backward (5 products; q, k, v, o, do, lse, delta read once, dq, dk, dv
written once), counting with the padding bias only the pairs whose key
is a real token.  It times the ``paddle_tpu_torch`` that the path
imports, so two checkouts compare in one run, each on PYTHONPATH in
turn.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from paddle_tpu_torch.tools.time_flash_fwd import (_bound, _device_ms, _ms,
                                                   _padding_lengths)


def _kernel_ms(fn, tries=3):
    """_device_ms of fn, traced again when a trace comes back without
    device time (it happened once in a few dozen traces on an H100)."""
    for _ in range(tries):
        ms = _device_ms(fn)
        if ms:
            return ms
    return ms


def _pair(fa, qt, kt, vt, dot, lse, delta, scale, causal, mask):
    """One dq and one dk/dv launch on the same inputs."""
    fa._launch_dq(qt, kt, vt, dot, lse, delta, scale, causal, mask)
    fa._launch_dkv(qt, kt, vt, dot, lse, delta, scale, causal, mask)


def _row(fa, F, q, k, v, do, scale, causal, mask, lib_mask, pairs, extra,
         reps):
    """The timings of one shape: q, k, v, do (B, H, S, D) bf16."""
    import torch
    b, h, s, d = q.shape
    qt, kt, vt, dot = (t.reshape(b * h, s, d) for t in (q, k, v, do))
    ot, lse = fa._launch(qt, kt, vt, scale, causal, mask)
    delta = fa._delta(dot, ot)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask,
                                         is_causal=causal, scale=scale)
    prod = 2 * d * pairs                       # one product's operations
    tb = b * h * s * d * 2                     # one bf16 tensor
    rb = b * h * s * 4                         # one f32 row vector
    row = {
        "shape": [b * h, s, s, d],
        "dq_ms": _ms(lambda: fa._launch_dq(qt, kt, vt, dot, lse, delta, scale,
                                           causal, mask), reps),
        "dkv_ms": _ms(lambda: fa._launch_dkv(qt, kt, vt, dot, lse, delta,
                                             scale, causal, mask), reps),
        "delta_ms": _ms(lambda: fa._delta(dot, ot), reps),
        "kernel_device_ms": _kernel_ms(lambda: _pair(
            fa, qt, kt, vt, dot, lse, delta, scale, causal, mask)),
        "library_ms": _ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True), reps),
        # dq reads q, k, v, do, lse, delta and writes dq
        "dq_bound_ms": _bound(3 * prod, 5 * tb + 2 * rb + extra),
        # dk/dv reads the same and writes dk, dv
        "dkv_bound_ms": _bound(4 * prod, 6 * tb + 2 * rb + extra),
        # the whole backward also reads o
        "bound_ms": _bound(5 * prod, 8 * tb + 2 * rb + extra)}
    row["pair_ms"] = row["dq_ms"] + row["dkv_ms"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import paddle_tpu_torch
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    rows = {}
    b, h, s = 8, 16, 1024
    for d in (64, 128):
        q, k, v, do = (rand(b, h, s, d) for _ in range(4))
        rows[f"gpt_d{d}_causal"] = _row(
            fa, F, q, k, v, do, d ** -0.5, True, None, None,
            s * (s + 1) // 2 * b * h, 0, args.reps)
        del q, k, v, do
    b, h, s, d = 128, 12, 128, 64
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    lens = torch.as_tensor(_padding_lengths(b, s), device="cuda")
    keep = torch.arange(s, device="cuda")[None] < lens[:, None]
    pad = fa.Mask(torch.where(keep, 0.0, -1e30)[:, None, None, :]
                  .contiguous(), None, None, h)
    real = int(keep.sum())
    learned = rand(1, h, s, s)
    for kind, m, lib_mask, pairs, extra in (
            ("bert_padding", pad, keep[:, None, None, :], h * s * real,
             b * s * 4),
            ("bert_learned_bias", fa.Mask(learned, None, None, h), learned,
             b * h * s * s, h * s * s * 2),
            ("bert_unmasked", None, None, b * h * s * s, 0)):
        rows[kind] = _row(fa, F, q, k, v, do, 0.125, False, m, lib_mask,
                          pairs, extra, args.reps)
    print(json.dumps({"package": paddle_tpu_torch.__file__, **rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
