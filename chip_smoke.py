#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. build   — compile every CUDA kernel of the path from paddle_tpu_torch/csrc
             (one nvcc per source, all started together).
2. check   — hold each kernel against its plain PyTorch version on the card,
             at the shapes GPT-2 345M gives it and at tail shapes, and a small
             GPT on the card against the same model on the CPU: forward,
             loss, gradients and one f32 TrainStep.
3. serve   — GPT-2 345M at full width and depth in bf16 answers a batch of
             B=8 prompts of S=1024 tokens: logits and next-token argmax, then
             gpt_loss scoring with the fused-CE flag off and on.  The launch
             counters are set to 0 just before and read just after.
4. train   — GPT-2 345M at full width and depth, f32 masters, trains as
             bench.py configures it: TrainStep with AMP O2 bf16 and
             AdamW(learning_rate=1e-4), 5 steps on one B=8, S=1024 batch.
             Counters set to 0 just before, read after every step.
5. timing  — each kernel, its plain version, the one-call PyTorch yardstick
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
# bf16 gradients: max |got - want| / (|want| + rms(want)) per tensor.  Both
# sides round to bf16, so an entry may differ by an ulp of itself (2^-7 of
# |want|); the rms floor keeps an error among small gradients from hiding
# behind the few large ones.  The limit sits above the kernels' readings and
# the rounding control's (p and ds left in f32), well below what a dropped
# tile or fragment gives (PERF.md, Findings)
TOL_GRAD_BF16 = 0.1
TOL_MOVE = 1e-2                # an AdamW move, relative to the move itself
TRAIN_STEPS = 5


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


def grad_err(a, b):
    """(max |a - b| / (|b| + rms(b)), max |a - b|); a must be finite."""
    import torch
    a, b = a.float(), b.float()
    if not bool(torch.isfinite(a).all()):
        fail("a kernel gradient is not finite")
    d = (a - b).abs()
    rms = b.pow(2).mean().sqrt()
    return float((d / (b.abs() + rms).clamp_min(1e-30)).max()), float(d.max())


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


def check_flash_bwd(g, fa, case):
    """dq, dk, dv kernels against flash_attention_bwd_reference; returns
    the largest absolute error."""
    import torch
    bh, sq, sk, d, dtype, causal = case
    qt, dot = rand(g, (bh, sq, d), dtype), rand(g, (bh, sq, d), dtype)
    kt, vt = rand(g, (bh, sk, d), dtype), rand(g, (bh, sk, d), dtype)
    scale = 1.0 / math.sqrt(d)
    ot, lse = fa.flash_attention_reference(qt, kt, vt, scale, causal)
    got = fa._launch_bwd(qt, kt, vt, ot, lse, dot, scale, causal)
    want = fa.flash_attention_bwd_reference(qt, kt, vt, ot, lse, dot, scale,
                                            causal)
    torch.cuda.synchronize()
    bf = dtype == torch.bfloat16
    errs = [grad_err(a, b) for a, b in zip(got, want)]
    names = ("dq", "dk", "dv")
    if bf:
        ok = all(e[0] <= TOL_GRAD_BF16 for e in errs)
        # rounding control: the plain version with p and ds left in f32,
        # read by the same measure
        ctl = fa.flash_attention_bwd_reference(
            *(t.float() for t in (qt, kt, vt, ot)), lse, dot.float(), scale,
            causal)
        ctl = [grad_err(c.to(dtype), w)[0] for c, w in zip(ctl, want)]
        detail = (", relative to |ref| + rms(ref): "
                  + " ".join(f"{n}={e[0]:.3g}" for n, e in zip(names, errs))
                  + " (rounding control "
                  + " ".join(f"{n}={c:.3g}" for n, c in zip(names, ctl))
                  + f"; tol {TOL_GRAD_BF16:g})")
    else:
        ok = all(e[1] <= TOL_F32 for e in errs)
        detail = f" (tol {TOL_F32:g})"
    if causal and sq > sk and float(got[0][:, :sq - sk].abs().max()) != 0:
        ok = False                        # rows with no key: dq = 0
    log(f"check flash_attention_bwd bh={bh} sq={sq} sk={sk} d={d} "
        f"{str(dtype)[6:]} causal={causal}: max_abs_err "
        + " ".join(f"{n}={e[1]:.3g}" for n, e in zip(names, errs))
        + detail + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("flash_attention backward kernels disagree with their plain "
             "version")
    return errs[0][1], max(errs[1][1], errs[2][1])


def check_small_train(GPT, gpt_loss, small, ids, TrainStep, AdamW):
    """A small f32 GPT on the card against the same model on the CPU:
    every parameter's gradient of gpt_loss, then one TrainStep.  Returns
    (largest absolute difference of gradients and loss, largest difference
    of a parameter's move over the size of that move)."""
    import torch
    gpu, cpu = GPT(small, device="cuda"), GPT(small, device="cpu")
    err = 0.0
    for m in (gpu, cpu):
        gpt_loss(m, ids, ids).backward()
    for name, p in cpu.named_parameters():
        err = max(err, float((getattr(gpu, name).grad.cpu() - p.grad)
                             .abs().max()))
        p.grad = getattr(gpu, name).grad = None
    old = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    losses = [float(TrainStep(m, gpt_loss, AdamW(learning_rate=1e-4))(
        ids, ids)) for m in (gpu, cpu)]
    err = max(err, abs(losses[0] - losses[1]))
    move_err = 0.0
    for name, p in cpu.named_parameters():
        want = p.detach() - old[name]
        got = getattr(gpu, name).detach().cpu() - old[name]
        if not bool(want.abs().max() > 0):
            fail(f"one AdamW step left {name} where it was")
        move_err = max(move_err, float((got - want).abs().max()
                                       / want.abs().max()))
    return err, move_err


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
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, gpt2_345m, gpt_loss, gpt_tiny
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ce
    from paddle_tpu_torch.optimizer import AdamW

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
    bwd_errs = [check_flash_bwd(g, fa, c) for c in [
        (B * H_, S, S, 64, bf16, True),        # GPT-2 345M layer shape
        (B * H_, S, S, 128, bf16, True),
        (B * H_, 1000, 1000, 64, bf16, True),  # key/query tails
    ]]
    dq_err = max(e[0] for e in bwd_errs)
    dkv_err = max(e[1] for e in bwd_errs)
    for c in [(4, 256, 256, 64, f32, True), (4, 200, 200, 128, f32, False),
              (4, 200, 128, 64, f32, True)]:   # sq > sk: rows with no key
        check_flash_bwd(g, fa, c)
    ce_err = max(check_ce(g, fused_ce, c) for c in [
        (B * S, 1024, 50304, bf16),            # GPT-2 345M scoring head
        (8000, 1024, 50304, bf16),             # token tail
    ])
    check_ce(g, fused_ce, (300, 256, 1000, f32))

    small = gpt_tiny(num_layers=2, hidden_size=128, num_heads=2,
                     max_seq_len=256)
    ids_s = np.random.default_rng(1).integers(0, small.vocab_size, (2, 256))
    gpu_s, cpu_s = GPT(small, device="cuda"), GPT(small, device="cpu")
    with torch.inference_mode():
        e_small = float((gpu_s(ids_s).cpu() - cpu_s(ids_s)).abs().max())
        for fused in (False, True):
            set_flags({"gpt_fused_ce": fused})
            e_small = max(e_small, abs(float(gpt_loss(gpu_s, ids_s, ids_s))
                                       - float(gpt_loss(cpu_s, ids_s,
                                                        ids_s))))
    set_flags({"gpt_fused_ce": False})
    log(f"check small GPT (2 layers, H=128, S=256, f32) card vs CPU: "
        f"max_abs_err={e_small:.3g} (tol {TOL_F32:g})")
    if e_small > TOL_F32:
        fail("small GPT on the card disagrees with the CPU")
    del gpu_s, cpu_s
    e_train, e_move = check_small_train(GPT, gpt_loss, small, ids_s,
                                        TrainStep, AdamW)
    log(f"check small GPT f32 gradients and one TrainStep (AdamW) card vs "
        f"CPU: gradients and loss max_abs_err={e_train:.3g} (tol "
        f"{TOL_F32:g}), parameter moves max_err/move={e_move:.3g} (tol "
        f"{TOL_MOVE:g})")
    if e_train > TOL_F32 or e_move > TOL_MOVE:
        fail("small GPT training on the card disagrees with the CPU")

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

    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fused_ce.launches = 0
    counts = []
    with torch.inference_mode():
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
    if fa.launches_dq or fa.launches_dkv:
        fail("a serving request launched a backward kernel")

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

    # serving-time measurements need the bf16 model; take them now and
    # free it before the training phase
    ids_t = torch.as_tensor(ids, device="cuda")
    with torch.inference_mode():
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
    w_head = model.wte.detach().clone()
    del model
    torch.cuda.empty_cache()

    # -- 4. train -----------------------------------------------------------
    t0 = time.perf_counter()
    tmodel = GPT(cfg, device="cuda")                  # f32 masters
    step = TrainStep(tmodel, gpt_loss, AdamW(learning_rate=1e-4),
                     amp_level="O2", amp_dtype="bfloat16")
    torch.cuda.synchronize()
    log(f"train: GPT-2 345M built in f32 in {time.perf_counter() - t0:.1f} "
        f"s; TrainStep(amp_level='O2', bf16), AdamW(learning_rate=1e-4), "
        f"B={B}, S={S}, {TRAIN_STEPS} steps on one batch")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fused_ce.launches = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    loss_t, train_counts = [], []
    for i in range(TRAIN_STEPS):
        if i == 1:                                    # after one warm-up
            e0.record()
        loss_t.append(step(ids_t, ids_t))
        train_counts.append((fa.launches, fa.launches_dq, fa.launches_dkv))
    e1.record()
    torch.cuda.synchronize()
    train_launches = {"flash_attention_fwd": fa.launches,
                      "flash_attention_bwd_dq": fa.launches_dq,
                      "flash_attention_bwd_dkv": fa.launches_dkv}
    step_ms = e0.elapsed_time(e1) / (TRAIN_STEPS - 1)
    train_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in loss_t]
    log(f"train: losses {losses}")
    log(f"train: launch counts after each step (flash fwd, dq, dk/dv): "
        f"{train_counts}")
    log(f"train: step {step_ms:.3f} ms (CUDA events, mean of "
        f"{TRAIN_STEPS - 1} steps after one warm-up), "
        f"{B * S / step_ms * 1e3:.1f} training tokens/s, "
        f"max_memory_allocated {train_mem} bytes")
    if not all(math.isfinite(x) for x in losses):
        fail("a training loss is not finite")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        fail("the first training loss is not near ln(V)")
    if not losses[-1] < losses[0]:
        fail("the training loss did not fall")
    want = [(L * (i + 1),) * 3 for i in range(TRAIN_STEPS)]
    if train_counts != want or fused_ce.launches:
        fail(f"launch counts {train_counts} != {L} forward, {L} dq and {L} "
             "dk/dv launches per step (and no fused_ce launch)")
    train_row = {"train_step_ms": step_ms,
                 "train_tokens_per_s": B * S / step_ms * 1e3,
                 "train_peak_bytes": train_mem, "train_losses": losses}
    del step, tmodel, loss_t
    torch.cuda.empty_cache()

    # -- 5. timing ----------------------------------------------------------
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
                    "launches": serve_launches["flash_attention_fwd"]
                    + train_launches["flash_attention_fwd"],
                    "max_abs_err": fa_err, "ms": fa_ms, "plain_ms": fa_plain,
                    "bound_ms": fa_bound, "bound_by": fa_by,
                    "library_ms": fa_lib})

    # backward: the dq and dk/dv kernels, the plain backward (dq, dk, dv
    # at once), and the library's whole backward as the yardstick
    dot = rand(g, (B * H_, S, 64), bf16)
    ot, lse = fa._launch(qt, kt, vt, sc, True)
    delta = fa._delta(dot, ot)
    dq_ms = cuda_ms(lambda: fa._launch_dq(qt, kt, vt, dot, lse, delta, sc,
                                          True))
    dkv_ms = cuda_ms(lambda: fa._launch_dkv(qt, kt, vt, dot, lse, delta, sc,
                                            True))
    bwd_plain = cuda_ms(lambda: fa.flash_attention_bwd_reference(
        qt, kt, vt, ot, lse, dot, sc, True), reps=3)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out_l = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                           scale=sc)
    do4 = dot.view(B, H_, S, 64)
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(
        out_l, (ql, kl, vl), do4, retain_graph=True))
    prod = 2 * B * H_ * 64 * visible_pairs(S, S, True)   # one product
    t_bytes = B * H_ * S * 64 * 2                        # one bf16 tensor
    r_bytes = B * H_ * S * 4                             # one f32 row vector
    # dq reads q, k, v, do, lse, delta and writes dq: 3 products
    dq_bound, dq_by = bound(3 * prod, 5 * t_bytes + 2 * r_bytes,
                            PEAK_BF16_FLOPS)
    # dk/dv reads q, k, v, do, lse, delta and writes dk, dv: 4 products
    dkv_bound, dkv_by = bound(4 * prod, 6 * t_bytes + 2 * r_bytes,
                              PEAK_BF16_FLOPS)
    # the whole backward: 5 products; reads q, k, v, o, do, lse, delta and
    # writes dq, dk, dv
    pair_bound, pair_by = bound(5 * prod, 8 * t_bytes + 2 * r_bytes,
                                PEAK_BF16_FLOPS)
    table.append({"kernel": "flash_attention_bwd (dq + dk/dv)",
                  "shape": f"bh={B * H_} s={S} d=64 bf16 causal",
                  "kernel_ms": dq_ms + dkv_ms, "dq_ms": dq_ms,
                  "dkv_ms": dkv_ms, "plain_ms": bwd_plain,
                  "library_ms": bwd_lib, "bound_ms": pair_bound,
                  "bound_by": pair_by, "launches_per_step": L})
    for name, ms, err, b_ms, b_by in (
            ("flash_attention_bwd_dq", dq_ms, dq_err, dq_bound, dq_by),
            ("flash_attention_bwd_dkv", dkv_ms, dkv_err, dkv_bound,
             dkv_by)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "paddle_tpu_torch/csrc/"
                                  "flash_attention_bwd.cu",
                        "replaces": "paddle_tpu/ops/pallas/flash_attention."
                                    + ("py:452" if name.endswith("dq")
                                       else "py:498"),
                        "launches": train_launches[name],
                        "max_abs_err": err, "ms": ms,
                        # the plain version and the library call compute
                        # dq, dk and dv in one call: the pair's work
                        "plain_ms": bwd_plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": bwd_lib})
    del qt, kt, vt, q4, k4, v4, ql, kl, vl, out_l, dot, ot, lse, delta

    n, hd, v = B * S, cfg.hidden_size, cfg.vocab_size
    h = rand(g, (n, hd), bf16)
    w = w_head
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

    log(json.dumps({
        "forward_ms": fwd_ms, "forward_tokens_per_s": B * S / fwd_ms * 1e3,
        "attention_share_of_forward": L * fa_ms / fwd_ms,
        "loss_unfused_ms": unfused_ms, "loss_fused_ms": fused_ms,
        "loss_unfused_peak_bytes": unfused_mem,
        "loss_fused_peak_bytes": fused_mem, **train_row,
        "attention_bwd_share_of_train_step": L * (dq_ms + dkv_ms)
        / step_ms}))

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
