"""Time the bf16 flash-attention bias gradient (the dbias kernel) on the
card at the shape the main path gives it: the learned-bias encoder's
(1, 12, 128, 128) bf16 bias over BERT-base's layer (B*H = 128*12, S = 128,
D = 64, non-causal).

    PYTHONPATH=. python paddle_tpu_torch/tools/time_dbias.py [--reps 20]

Prints the card's name and power limit (nvidia-smi), then one JSON line:
the mean ms of one dbias call (``flash_attention._launch_dbias``) by CUDA
events, the calls queued behind a sleeping kernel; the device ms of its
kernels by name (torch.profiler over 5 calls: the split pass and, where
there is one, the ordered sum of the splits); the library's ms for the
mask's gradient (``torch.autograd.grad`` of ``scaled_dot_product_attention``
to the mask alone, and to q, k, v and the mask, on the same inputs); and
the least time the card could take (the larger of the bytes at 3.35 TB/s
and the operations at 989 TFLOP/s: q, k, v, do, lse, delta and the bias
read once, dbias written once, two products over every (query, key)
pair).  It times the ``paddle_tpu_torch`` that the path imports, so two
checkouts compare in one run, each on PYTHONPATH in turn.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from paddle_tpu_torch.tools.time_flash_fwd import _bound, _device_ms, _ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_dbias: no CUDA device", file=sys.stderr)
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

    b, h, s, d, scale = 128, 12, 128, 64, 0.125
    q, k, v, do = (rand(b, h, s, d) for _ in range(4))
    bias = rand(1, h, s, s)
    qt, kt, vt, dot = (t.reshape(b * h, s, d) for t in (q, k, v, do))
    mask = fa.Mask(bias, None, None, h)
    ot, lse = fa._launch(qt, kt, vt, scale, False, mask)
    delta = fa._delta(dot, ot)

    def dbias():
        return fa._launch_dbias(qt, kt, vt, dot, lse, delta, scale, False,
                                mask)

    ql, kl, vl, ml = (t.detach().clone().requires_grad_()
                      for t in (q, k, v, bias))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml,
                                         scale=scale)
    tb = b * h * s * d * 2                     # one bf16 tensor
    rb = b * h * s * 4                         # one f32 row vector
    bb = h * s * s * 2                         # the bf16 bias
    row = {
        "shape": [b * h, s, s, d], "bias": list(bias.shape),
        "ms": _ms(dbias, args.reps),
        "kernel_device_ms": _device_ms(dbias),
        "library_mask_ms": _ms(lambda: torch.autograd.grad(
            out, (ml,), do, retain_graph=True), args.reps),
        "library_qkv_mask_ms": _ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl, ml), do, retain_graph=True), args.reps),
        "bound_ms": _bound(2 * 2 * d * b * h * s * s,
                           4 * tb + 2 * rb + 2 * bb)}
    print(json.dumps({"package": paddle_tpu_torch.__file__,
                      "encoder_learned_bias": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
