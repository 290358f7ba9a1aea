"""Where the time of a GPT-2 345M serving request, or training step, goes
on the card.

    python -m paddle_tpu_torch.tools.profile_gpt [--batch 8] [--seq 1024]
    python -m paddle_tpu_torch.tools.profile_gpt --train

Builds GPT-2 345M at full width and depth on the card and warms up.
Serving (the default): bf16 parameters, and one JSON line for each request
kind (logits, gpt_loss unfused, gpt_loss fused).  ``--train``: f32
parameters under TrainStep with AMP O2 bf16 and AdamW(learning_rate=1e-4),
as bench.py trains, and one JSON line for a training step.  Each line
holds the wall time between synchronisations (mean of a few runs), the
device time of the kernels grouped by kind (from torch.profiler; under
--train the kernels launched inside the ``TrainStep.update`` range form
the "optimizer" group), the device's busy and idle share of the wall time,
and the kernels that took most device time.  The card's name and power
limit (nvidia-smi) come first.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

# kernel-name fragments -> group, tried in order
_GROUPS = (
    ("flash_attention_fwd", ("fa_fwd",)),
    ("flash_attention_bwd_dq", ("fa_bwd_dq",)),
    ("flash_attention_bwd_dkv", ("fa_bwd_dkv",)),
    ("fused_ce_fwd", ("ce_partial", "ce_merge")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reductions (LN mean, var)", ("reduce",)),
    ("gather / index", ("index", "gather")),
    ("copies (permute, cat, cast)", ("copy", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


_UPDATE_RANGE = "TrainStep.update"


def _in_range(evt, name: str) -> bool:
    while evt is not None:
        if evt.name == name:
            return True
        evt = evt.cpu_parent
    return False


def _request(fn, reps: int):
    """(mean wall ms, traced ms, {group: device ms}, busy ms, top kernels)
    of fn().  Kernels launched by an op inside a ``TrainStep.update`` range
    count as the "optimizer" group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    opt_ms = {}                           # kernel name -> ms in the update
    for evt in prof.events():
        if evt.kernels and _in_range(evt, _UPDATE_RANGE):
            for k in evt.kernels:
                opt_ms[k.name] = opt_ms.get(k.name, 0.0) + k.duration / 1e3
    groups, kernels = {}, []
    if opt_ms:
        groups["optimizer"] = sum(opt_ms.values())
    for evt in prof.key_averages():
        # the update range shows on the device's timeline too: not a kernel
        if evt.device_type != torch.autograd.DeviceType.CUDA or \
                evt.key == _UPDATE_RANGE:
            continue
        ms = evt.self_device_time_total / 1e3
        kernels.append((ms, evt.count, evt.key[:90]))
        ms -= opt_ms.get(evt.key, 0.0)
        if ms <= 0:
            continue
        groups[_group(evt.key)] = groups.get(_group(evt.key), 0.0) + ms
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    return wall_ms, traced_ms, groups, busy, kernels[:8]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of serving")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_gpt: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, gpt2_345m, gpt_loss
    from paddle_tpu_torch.optimizer import AdamW

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cfg = gpt2_345m(max_seq_len=args.seq)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.seq)), device="cuda")
    if args.train:
        step = TrainStep(GPT(cfg, device="cuda"), gpt_loss,
                         AdamW(learning_rate=1e-4), amp_level="O2",
                         amp_dtype="bfloat16")
        requests = {"train_step": lambda: step(ids, ids)}
    else:
        model = GPT(cfg, device="cuda").to(torch.bfloat16)

        def loss(fused):
            set_flags({"gpt_fused_ce": fused})
            return gpt_loss(model, ids, ids)

        requests = {"logits": lambda: model(ids),
                    "loss_unfused": lambda: loss(False),
                    "loss_fused": lambda: loss(True)}
    # serving records no tape; training needs it
    with contextlib.nullcontext() if args.train else torch.inference_mode():
        for fn in requests.values():      # builds the kernels, warms up
            fn()
            fn()
        results = {name: _request(fn, args.reps)
                   for name, fn in requests.items()}
    for name, (wall, traced, groups, busy, top) in results.items():
        print(json.dumps({
            "request": name, "batch": args.batch, "seq": args.seq,
            "wall_ms": wall, "tokens_per_s": args.batch * args.seq / wall
            * 1e3, "traced_wall_ms": traced, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / traced),
            "device_ms_by_group": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "count": n, "name": k}
                            for ms, n, k in top]}), flush=True)
    set_flags({"gpt_fused_ce": False})
    return 0


if __name__ == "__main__":
    sys.exit(main())
