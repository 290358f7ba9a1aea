#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. build   — compile every CUDA kernel of the path from paddle_tpu_torch/csrc
             (one nvcc per source, all started together).
2. check   — hold each kernel against its plain PyTorch version on the card,
             at the shapes GPT-2 345M gives it and at tail shapes, and a small
             GPT on the card against the same model on the CPU.
3. serve   — GPT-2 345M at full width and depth in bf16 answers a batch of
             B=8 prompts of S=1024 tokens: logits and next-token argmax, then
             gpt_loss scoring with the fused-CE flag off and on.  The launch
             counters are set to 0 just before and read just after.
4. timing  — each kernel, its plain version, the one-call PyTorch yardstick
             and the least time the card could take for the same work;
             tokens/s of the forward.

The last three lines of standard output are the card's name and power limit
(nvidia-smi), one JSON object with the kernel table, and the result line
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.  It imports no JAX and nothing of paddle_tpu.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

B, S = 8, 1024                 # the serving batch of GPT-2 345M
TOL_BF16 = 2e-2                # bf16 outputs: a few bf16 ulps of O(1) values
TOL_F32 = 1e-4                 # f32 outputs: summation order only
TOL_LSE = 1e-3                 # f32 lse / logz from bf16 inputs
TOL_LOSS_BF16 = 2e-2           # fused vs unfused loss in bf16 (logits rounding)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds of fn() on the card, between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(flops, nbytes, peak_flops):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a, b):
    """max |a - b| over entries where both are finite; the non-finite
    entries (lse = -inf of an empty row) must match exactly."""
    import torch
    a, b = a.float(), b.float()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        fail("non-finite entries differ between kernel and plain version")
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


def visible_pairs(sq, sk, causal):
    """(query, key) pairs the causal, end-aligned mask leaves visible."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def rand(g, shape, dtype, scale=1.0):
    import torch
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def check_flash(g, fa, case):
    import torch
    bh, sq, sk, d, dtype, causal = case
    qt = rand(g, (bh, sq, d), dtype)
    kt, vt = rand(g, (bh, sk, d), dtype), rand(g, (bh, sk, d), dtype)
    scale = 1.0 / math.sqrt(d)
    out_k, lse_k = fa._launch(qt, kt, vt, scale, causal)
    out_p, lse_p = fa.flash_attention_reference(qt, kt, vt, scale, causal)
    torch.cuda.synchronize()
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    e_out, e_lse = max_err(out_k, out_p), max_err(lse_k, lse_p)
    ok = e_out <= tol and e_lse <= (TOL_LSE if dtype == torch.bfloat16
                                    else TOL_F32)
    log(f"check flash_attention bh={bh} sq={sq} sk={sk} d={d} "
        f"{str(dtype)[6:]} causal={causal}: max_abs_err out={e_out:.3g} "
        f"lse={e_lse:.3g} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("flash_attention kernel disagrees with its plain version")
    return e_out


def check_ce(g, fused_ce, case):
    import torch
    n, hd, v, dtype = case
    h = rand(g, (n, hd), dtype)
    w = rand(g, (v, hd), dtype, 0.02)
    lz_k = fused_ce._launch(h, w)
    lz_p = fused_ce.ce_logz_reference(h, w)
    torch.cuda.synchronize()
    tol = TOL_LSE if dtype == torch.bfloat16 else TOL_F32
    e = max_err(lz_k, lz_p)
    log(f"check fused_ce logz n={n} h={hd} v={v} {str(dtype)[6:]}: "
        f"max_abs_err={e:.3g} (tol {tol:g}) {'ok' if e <= tol else 'FAIL'}")
    if e > tol:
        fail("fused_ce kernel disagrees with its plain version")
    return e


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import GPT, gpt2_345m, gpt_loss, gpt_tiny
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ce

    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 2. check -----------------------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(0)
    H_ = 16
    fa_err = max(check_flash(g, fa, c) for c in [
        (B * H_, S, S, 64, bf16, True),        # GPT-2 345M layer shape
        (B * H_, S, S, 128, bf16, True),
        (B * H_, 1000, 1000, 64, bf16, True),  # key/query tails
    ])
    for c in [(4, 256, 256, 64, f32, True), (4, 200, 200, 128, f32, False),
              (4, 200, 128, 64, f32, True)]:   # sq > sk: rows with no key
        check_flash(g, fa, c)
    ce_err = max(check_ce(g, fused_ce, c) for c in [
        (B * S, 1024, 50304, bf16),            # GPT-2 345M scoring head
        (8000, 1024, 50304, bf16),             # token tail
    ])
    check_ce(g, fused_ce, (300, 256, 1000, f32))

    small = gpt_tiny(num_layers=2, hidden_size=128, num_heads=2,
                     max_seq_len=256)
    ids_s = np.random.default_rng(1).integers(0, small.vocab_size, (2, 256))
    gpu_s, cpu_s = GPT(small, device="cuda"), GPT(small, device="cpu")
    e_small = float((gpu_s(ids_s).cpu() - cpu_s(ids_s)).abs().max())
    for fused in (False, True):
        set_flags({"gpt_fused_ce": fused})
        e_small = max(e_small, abs(float(gpt_loss(gpu_s, ids_s, ids_s))
                                   - float(gpt_loss(cpu_s, ids_s, ids_s))))
    set_flags({"gpt_fused_ce": False})
    log(f"check small GPT (2 layers, H=128, S=256, f32) card vs CPU: "
        f"max_abs_err={e_small:.3g} (tol {TOL_F32:g})")
    if e_small > TOL_F32:
        fail("small GPT on the card disagrees with the CPU")
    del gpu_s, cpu_s

    # -- 3. serve -----------------------------------------------------------
    cfg = gpt2_345m(max_seq_len=S)
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda").to(bf16)
    torch.cuda.synchronize()
    log(f"serve: GPT-2 345M ({cfg.num_layers} layers, H={cfg.hidden_size}, "
        f"V={cfg.vocab_size}) built in bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    L = cfg.num_layers

    fa.launches = 0
    fused_ce.launches = 0
    counts = []
    logits = model(ids)
    next_tok = logits[:, -1].float().argmax(-1)
    counts.append((fa.launches, fused_ce.launches))
    set_flags({"gpt_fused_ce": False})
    loss_unfused = float(gpt_loss(model, ids, ids))
    counts.append((fa.launches, fused_ce.launches))
    set_flags({"gpt_fused_ce": True})
    loss_fused = float(gpt_loss(model, ids, ids))
    counts.append((fa.launches, fused_ce.launches))
    set_flags({"gpt_fused_ce": False})
    torch.cuda.synchronize()
    serve_launches = {"flash_attention_fwd": fa.launches,
                      "fused_ce_fwd": fused_ce.launches}

    log(f"serve: logits {tuple(logits.shape)} {logits.dtype}, next tokens "
        f"{next_tok[:4].tolist()}..., loss unfused={loss_unfused:.6f} "
        f"fused={loss_fused:.6f} (ln V = {math.log(cfg.vocab_size):.6f})")
    log(f"serve: launch counts after each request (flash, fused_ce): "
        f"{counts}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail("logits are not finite values of shape (B, S, V)")
    if not (math.isfinite(loss_unfused) and math.isfinite(loss_fused)):
        fail("a loss is not finite")
    if abs(loss_unfused - loss_fused) > TOL_LOSS_BF16:
        fail(f"fused and unfused losses differ by "
             f"{abs(loss_unfused - loss_fused):.3g} > {TOL_LOSS_BF16}")
    if abs(loss_unfused - math.log(cfg.vocab_size)) > 1.0:
        fail("random-init loss is not near ln(V)")
    if counts != [(L, 0), (2 * L, 0), (3 * L, 1)]:
        fail(f"launch counts {counts} != {L} flash launches per forward "
             "and one fused_ce launch")
    del logits

    # -- 4. timing ----------------------------------------------------------
    table, kernels = [], []
    qt = rand(g, (B * H_, S, 64), bf16)
    kt, vt = rand(g, (B * H_, S, 64), bf16), rand(g, (B * H_, S, 64), bf16)
    sc = 0.125
    q4, k4, v4 = (t.view(B, H_, S, 64) for t in (qt, kt, vt))
    fa_ms = cuda_ms(lambda: fa._launch(qt, kt, vt, sc, True))
    fa_plain = cuda_ms(lambda: fa.flash_attention_reference(qt, kt, vt, sc,
                                                            True), reps=3)
    fa_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=sc))
    fa_bound, fa_by = bound(4 * B * H_ * 64 * visible_pairs(S, S, True),
                            4 * B * H_ * S * 64 * 2 + B * H_ * S * 4,
                            PEAK_BF16_FLOPS)
    table.append({"kernel": "flash_attention_fwd",
                  "shape": f"bh={B * H_} s={S} d=64 bf16 causal",
                  "kernel_ms": fa_ms, "plain_ms": fa_plain,
                  "library_ms": fa_lib, "bound_ms": fa_bound,
                  "launches_per_forward": L})
    kernels.append({"name": "flash_attention_fwd", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                    "replaces": "paddle_tpu/ops/pallas/flash_attention.py:190",
                    "launches": serve_launches["flash_attention_fwd"],
                    "max_abs_err": fa_err, "ms": fa_ms, "plain_ms": fa_plain,
                    "bound_ms": fa_bound, "bound_by": fa_by,
                    "library_ms": fa_lib})
    del qt, kt, vt, q4, k4, v4

    n, hd, v = B * S, cfg.hidden_size, cfg.vocab_size
    h = rand(g, (n, hd), bf16)
    w = model.wte.detach()
    ce_ms = cuda_ms(lambda: fused_ce._launch(h, w), reps=5)
    ce_plain = cuda_ms(lambda: fused_ce.ce_logz_reference(h, w), reps=3)
    ce_lib = cuda_ms(lambda: torch.logsumexp(h @ w.T, -1), reps=5)
    ce_bound, ce_by = bound(2 * n * v * hd, (n * hd + v * hd) * 2 + n * 4,
                            PEAK_BF16_FLOPS)
    table.append({"kernel": "fused_ce_fwd",
                  "shape": f"n={n} h={hd} v={v} bf16",
                  "kernel_ms": ce_ms, "plain_ms": ce_plain,
                  "library_ms": ce_lib, "bound_ms": ce_bound,
                  "launches_per_forward": 1})
    kernels.append({"name": "fused_ce_fwd", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/fused_ce_fwd.cu",
                    "replaces": "paddle_tpu/ops/pallas/fused_ce.py:79",
                    "launches": serve_launches["fused_ce_fwd"],
                    "max_abs_err": ce_err, "ms": ce_ms, "plain_ms": ce_plain,
                    "bound_ms": ce_bound, "bound_by": ce_by,
                    "library_ms": ce_lib})
    del h
    for row in table:
        log(json.dumps(row))

    ids_t = torch.as_tensor(ids, device="cuda")
    fwd_ms = cuda_ms(lambda: model(ids_t), reps=3, warmup=1)
    set_flags({"gpt_fused_ce": False})
    torch.cuda.reset_peak_memory_stats()
    unfused_ms = cuda_ms(lambda: gpt_loss(model, ids_t, ids_t), reps=3,
                         warmup=1)
    unfused_mem = torch.cuda.max_memory_allocated()
    set_flags({"gpt_fused_ce": True})
    torch.cuda.reset_peak_memory_stats()
    fused_ms = cuda_ms(lambda: gpt_loss(model, ids_t, ids_t), reps=3,
                       warmup=1)
    fused_mem = torch.cuda.max_memory_allocated()
    set_flags({"gpt_fused_ce": False})
    log(json.dumps({
        "forward_ms": fwd_ms, "forward_tokens_per_s": B * S / fwd_ms * 1e3,
        "attention_share_of_forward": L * fa_ms / fwd_ms,
        "loss_unfused_ms": unfused_ms, "loss_fused_ms": fused_ms,
        "loss_unfused_peak_bytes": unfused_mem,
        "loss_fused_peak_bytes": fused_mem}))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
