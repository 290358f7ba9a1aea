"""Time the fused linear + cross-entropy backward at GPT-2 345M's training
head on the card: N = 8192 tokens (B=8, S=1024), H = 1024, V = 50304, bf16.

    PYTHONPATH=. python paddle_tpu_torch/tools/time_ce_bwd.py [--reps 5]

Prints the card's name and power limit (nvidia-smi), then one JSON line:
the mean ms of one backward call (``fused_ce._launch_bwd``: dh and dW
without the gold terms; CUDA events, the calls queued behind a sleeping
kernel), the device ms of each of its kernels by name (torch.profiler over
3 calls), the library's ms for the same function (softmax and the bf16
products in PyTorch), the pair's bound (3 products at 989 TFLOP/s),
the bytes one call allocates beyond its inputs at its peak, and the
SHA-256 of the bits of (dh, dW), so that two checkouts' outputs on the
same inputs compare bitwise.  It times the
``paddle_tpu_torch`` that the path imports, so two checkouts compare in
one run, each on PYTHONPATH in turn.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

PEAK_BF16_FLOPS = 989e12
QUEUE_CYCLES = 500_000_000     # about 0.3 s of the card's clock


def _ms(fn, reps):
    import torch
    for _ in range(2):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_ce_bwd: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch
    from paddle_tpu_torch.ops.cuda import fused_ce
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    n, hd, v = 8192, 1024, 50304
    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(n, hd, generator=g, device="cuda").bfloat16()
    w = (torch.randn(v, hd, generator=g, device="cuda") * 0.02).bfloat16()
    logz = fused_ce.ce_logz_reference(h, w)
    gv = torch.randn(n, generator=g, device="cuda") / n

    def pair():
        return fused_ce._launch_bwd(h, w, logz, gv)

    def library():
        p = (torch.softmax((h @ w.T).float(), -1) * gv[:, None]).bfloat16()
        return p @ w, p.T @ h

    pair()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = pair()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    # the outputs' bits: two checkouts whose kernels agree bitwise print
    # the same digest
    digest = hashlib.sha256(b"".join(
        t.contiguous().view(torch.int16).cpu().numpy().tobytes()
        for t in out)).hexdigest()
    del out
    pair_ms = _ms(pair, args.reps)
    lib_ms = _ms(library, 3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pair()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.self_device_time_total > 0:
            kernels[evt.key[:80]] = evt.self_device_time_total / 1e3 / 3
    print(json.dumps({
        "package": paddle_tpu_torch.__file__, "shape": [n, hd, v],
        "pair_ms": pair_ms, "kernel_device_ms": kernels,
        "library_ms": lib_ms,
        "pair_bound_ms": 3 * 2 * n * v * hd / PEAK_BF16_FLOPS * 1e3,
        "call_extra_peak_bytes": extra, "outputs_sha256": digest}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
