"""Time the fused linear + cross-entropy forward (the logz kernel) at GPT-2
345M's head on the card: N = 8192 tokens (B=8, S=1024), H = 1024, V =
50304, bf16.

    PYTHONPATH=. python paddle_tpu_torch/tools/time_ce_fwd.py [--reps 10]

Prints the card's name and power limit (nvidia-smi), then one JSON line:
the mean ms of one logz call (``fused_ce._launch``) by CUDA events, the
calls queued behind a sleeping kernel; the device ms of its kernels by
name (torch.profiler over 5 calls: the partial pass and the merge of the
partial pairs); the library's ms for the same function
(``torch.logsumexp(h @ W.T, -1)``); and the least time the card could
take (the larger of 2 N V H operations at 989 TFLOP/s and the bytes of h
and W read once and logz written once at 3.35 TB/s).  It times the
``paddle_tpu_torch`` that the path imports, so two checkouts compare in
one run, each on PYTHONPATH in turn.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from paddle_tpu_torch.tools.time_flash_fwd import _bound, _device_ms, _ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_ce_fwd: no CUDA device", file=sys.stderr)
        return 2

    import paddle_tpu_torch
    from paddle_tpu_torch.ops.cuda import fused_ce

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    n, hd, v = 8192, 1024, 50304
    h = torch.randn(n, hd, generator=g, device="cuda").bfloat16()
    w = (0.02 * torch.randn(v, hd, generator=g, device="cuda")).bfloat16()
    row = {
        "shape": [n, hd, v],
        "ms": _ms(lambda: fused_ce._launch(h, w), args.reps),
        "kernel_device_ms": _device_ms(lambda: fused_ce._launch(h, w)),
        "library_ms": _ms(lambda: torch.logsumexp(h @ w.T, -1), args.reps),
        "bound_ms": _bound(2 * n * v * hd, (n * hd + v * hd) * 2 + n * 4)}
    print(json.dumps({"package": paddle_tpu_torch.__file__,
                      "gpt2_345m_head": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
