"""Time the bf16 flash-attention forward on the card at the shapes the main
paths give it: GPT-2 345M's layer (B*H = 8*16, S = 1024, causal) at head
dims 64 and 128, and BERT-base's layer (B*H = 128*12, S = 128) with the
padded batch's (128, 1, 1, 128) f32 padding bias, with the learned-bias
encoder's (1, 12, 128, 128) bf16 bias, and without a mask.

    PYTHONPATH=. python paddle_tpu_torch/tools/time_flash_fwd.py [--reps 20]

Prints the card's name and power limit (nvidia-smi), then one JSON line:
for each shape the mean ms of one forward call (``flash_attention._launch``;
CUDA events, the calls queued behind a sleeping kernel), the device ms of
its kernel by name (torch.profiler over 5 calls), the ms of
``scaled_dot_product_attention`` on the same inputs (the library's
yardstick), and the least time the card could take (the larger of the
bytes at 3.35 TB/s and the operations at 989 TFLOP/s; with the padding
bias, the pairs whose key is a real token).  It times the
``paddle_tpu_torch`` that the path imports, so two checkouts compare in
one run, each on PYTHONPATH in turn.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
QUEUE_CYCLES = 500_000_000     # about 0.3 s of the card's clock


def _ms(fn, reps):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_ms(fn, calls=5):
    """{kernel name: device ms a call} of fn's kernels (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {evt.key[:80]: evt.self_device_time_total / 1e3 / calls
            for evt in prof.key_averages() if evt.self_device_time_total > 0}


def _padding_lengths(b, s, vocab=30522, seed=0):
    """The per-sample lengths of chip_smoke.py's padded BERT batch (its
    draws, in their order)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rng.integers(0, vocab, (b, s))
    rng.random((b, s))
    rng.integers(0, 2, (b,))
    return rng.integers(s // 2, s + 1, (b,))


def _bound(flops, nbytes):
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_flash_fwd: no CUDA device", file=sys.stderr)
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
        q, k, v = (rand(b, h, s, d) for _ in range(3))
        qt, kt, vt = (t.view(b * h, s, d) for t in (q, k, v))
        sc = d ** -0.5
        pairs = s * (s + 1) // 2 * b * h             # causal, visible
        rows[f"gpt_d{d}_causal"] = {
            "shape": [b * h, s, s, d],
            "ms": _ms(lambda: fa._launch(qt, kt, vt, sc, True), args.reps),
            "kernel_device_ms": _device_ms(
                lambda: fa._launch(qt, kt, vt, sc, True)),
            "library_ms": _ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=sc), args.reps),
            "bound_ms": _bound(4 * d * pairs,
                               4 * b * h * s * d * 2 + b * h * s * 4)}
    b, h, s, d = 128, 12, 128, 64
    q, k, v = (rand(b, h, s, d) for _ in range(3))
    qt, kt, vt = (t.view(b * h, s, d) for t in (q, k, v))
    lens = torch.as_tensor(_padding_lengths(b, s), device="cuda")
    keep = torch.arange(s, device="cuda")[None] < lens[:, None]
    mask = fa.Mask(torch.where(keep, 0.0, -1e30)[:, None, None, :]
                   .contiguous(), None, None, h)
    real = int(keep.sum())
    learned = rand(1, h, s, s)
    tensors = 4 * b * h * s * d * 2 + b * h * s * 4
    for kind, m, lib_mask, pairs, extra in (
            ("bert_padding", mask, keep[:, None, None, :], h * s * real,
             b * s * 4),
            ("bert_learned_bias", fa.Mask(learned, None, None, h), learned,
             b * h * s * s, h * s * s * 2),
            ("bert_unmasked", None, None, b * h * s * s, 0)):
        rows[kind] = {
            "shape": [b * h, s, s, d],
            "ms": _ms(lambda: fa._launch(qt, kt, vt, 0.125, False, m),
                      args.reps),
            "kernel_device_ms": _device_ms(
                lambda: fa._launch(qt, kt, vt, 0.125, False, m)),
            "library_ms": _ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=0.125), args.reps),
            "bound_ms": _bound(4 * d * pairs, tensors + extra)}
    print(json.dumps({"package": paddle_tpu_torch.__file__, **rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
