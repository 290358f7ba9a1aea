"""Where the time of a GPT-2 345M serving request or training step, of a
BERT-base training step, of a long-sequence training step, or of a
Transformer-base translation training step or beam-search request goes
on the card.

    python -m paddle_tpu_torch.tools.profile_gpt [--batch 8] [--seq 1024]
    python -m paddle_tpu_torch.tools.profile_gpt --train
    python -m paddle_tpu_torch.tools.profile_gpt --train --fused
    python -m paddle_tpu_torch.tools.profile_gpt --train --remat --recompute
    python -m paddle_tpu_torch.tools.profile_gpt --longseq [--seq 8192]
    python -m paddle_tpu_torch.tools.profile_gpt --bert
    python -m paddle_tpu_torch.tools.profile_gpt --encoder-bias
    python -m paddle_tpu_torch.tools.profile_gpt --seq2seq [--serve]

Builds GPT-2 345M at full width and depth on the card and warms up.
Serving (the default): bf16 parameters, and one JSON line for each request
kind (logits, gpt_loss unfused, gpt_loss fused).  ``--train``: f32
parameters under TrainStep with AMP O2 bf16 and AdamW(learning_rate=1e-4),
as bench.py trains, and one JSON line for a training step.  ``--train
--fused``: the fused training path instead (FLAGS_gpt_fused_ce,
AdamW(use_fused=True, weight_decay=0.01) with ClipGradByGlobalNorm(1.0) and
a warmup-then-cosine rate, accumulate_steps=2 over a global batch of twice
--batch).  ``--remat`` / ``--recompute`` (with ``--train``): the model's
per-layer remat, TrainStep(recompute=True).  ``--longseq``: one step of
bench.py's bench_longseq_flash model (4 layers, H=1024, 8 heads of 128,
V=8192, remat=True, O2 bf16, AdamW(1e-4)) at B=1, S=8192 unless
--batch / --seq say otherwise.  ``--bert``: one BERT-base pretraining
step as bench.py trains it on its padded batch (f32 parameters, each
layer recomputed in the backward as bench_bert's remat=True asks,
TrainStep with AMP O2 bf16,
AdamW(learning_rate=1e-4), bert_pretrain_loss, B=128, S=128 unless
--batch / --seq say otherwise, lengths in [S/2, S]).  ``--encoder-bias``:
one step of a 12-layer TransformerEncoder (768, 12 heads, 3072, GELU)
that trains a learned (1, 12, S, S) attention bias as its src_mask, mean
square error against a fixed target, the same TrainStep and AdamW, B=128,
S=128 by default.  ``--seq2seq``: one step of chip_smoke.py's
seq2seq-train (Transformer-base, V=30000 + 30000, O2 bf16, Adam(beta2
0.98, epsilon 1e-9) under NoamDecay(512, 4000, 2.0), dropout 0.1,
label-smoothed loss, B=32 sources of 256 and targets of 128); with
``--serve``, one seq2seq-serve request instead (the model in bf16, 8
sources, the encoder and a beam-4 search of 128 steps), whose line adds
the mean ms of a beam step.  The composition, its batch and its beam cell
are chip_smoke.py's (run from the repository's root).  Each line
holds the wall time between synchronisations (mean of a few runs), the
device time of the kernels grouped by kind (from torch.profiler; under
--train the kernels launched inside the ``TrainStep.update`` range form
the "optimizer" group), the device's busy and idle share of the wall time,
the kernels that took most device time, the host (CPU) time of the
``TrainStep.update`` and ``recompute.replay`` ranges in the traced run,
and the Python collector's runs and ms per untraced run.  The card's
name and power limit (nvidia-smi) come first.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time

# kernel-name fragments -> group, tried in order
_GROUPS = (
    ("flash_attention_fwd", ("fa_fwd",)),
    ("flash_attention_bwd_dq", ("fa_bwd_dq",)),
    ("flash_attention_bwd_dkv", ("fa_bwd_dkv",)),
    ("flash_attention_dbias", ("dbias_",)),
    ("fused_ce_fwd", ("ce_logz_pass", "ce_partial", "ce_merge")),
    # the bf16 backward's P pass builds the probabilities both use: it
    # counts with dh, as the chip_smoke.py kernel table counts it
    ("fused_ce_bwd_dh", ("ce_bwd_p_pass", "ce_bwd_dh_pass",
                         "ce_bwd_fma_kernel<true>")),
    ("fused_ce_bwd_dw", ("ce_bwd_dw_pass", "ce_bwd_fma_kernel<false>")),
    # launched through ctypes, the fused Adam kernel has no PyTorch op to
    # tie it to the TrainStep.update range: its name puts it there
    ("optimizer", ("adam_kernel",)),
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
# host-side ranges whose CPU time each line reports: the update and a
# recompute region's replay (jit/recompute.py)
_HOST_RANGES = (_UPDATE_RANGE, "recompute.replay")


def _in_range(evt, name: str) -> bool:
    while evt is not None:
        if evt.name == name:
            return True
        evt = evt.cpu_parent
    return False


@contextlib.contextmanager
def gc_time():
    """{"collections": n, "ms": host ms} of the Python garbage collector's
    runs inside the block (``gc.callbacks``)."""
    out, start = {"collections": 0, "ms": 0.0}, []

    def cb(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            out["collections"] += 1
            out["ms"] += (time.perf_counter() - start.pop()) * 1e3
    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


def _request(fn, reps: int):
    """(mean wall ms, traced ms, {group: device ms}, busy ms, top kernels,
    {host range: CPU ms}, the collector's time a run) of fn().  Kernels
    launched by an op inside a ``TrainStep.update`` range count as the
    "optimizer" group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with gc_time() as gc_run:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    gc_run = {"collections": gc_run["collections"] / reps,
              "ms": gc_run["ms"] / reps}

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
    host = {evt.key: evt.cpu_time_total / 1e3 for evt in prof.key_averages()
            if evt.key in _HOST_RANGES
            and evt.device_type == torch.autograd.DeviceType.CPU}
    groups, kernels = {}, []
    if opt_ms:
        groups["optimizer"] = sum(opt_ms.values())
    for evt in prof.key_averages():
        # the host's ranges show on the device's timeline too: not kernels
        if evt.device_type != torch.autograd.DeviceType.CUDA or \
                evt.key in _HOST_RANGES:
            continue
        ms = evt.self_device_time_total / 1e3
        kernels.append((ms, evt.count, evt.key[:90]))
        ms -= opt_ms.get(evt.key, 0.0)
        if ms <= 0:
            continue
        groups[_group(evt.key)] = groups.get(_group(evt.key), 0.0) + ms
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    return wall_ms, traced_ms, groups, busy, kernels[:8], host, gc_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="batch (8, or 128 with --bert)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (1024, or 128 with --bert)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of serving")
    ap.add_argument("--fused", action="store_true",
                    help="with --train: the fused training path")
    ap.add_argument("--remat", action="store_true",
                    help="with --train: recompute each layer")
    ap.add_argument("--recompute", action="store_true",
                    help="with --train: TrainStep(recompute=True)")
    ap.add_argument("--longseq", action="store_true",
                    help="a step of bench_longseq_flash's model")
    ap.add_argument("--bert", action="store_true",
                    help="a BERT-base training step on a padded batch")
    ap.add_argument("--encoder-bias", action="store_true",
                    help="a training step of an encoder with a learned "
                         "attention bias")
    ap.add_argument("--seq2seq", action="store_true",
                    help="a Transformer-base translation training step")
    ap.add_argument("--serve", action="store_true",
                    help="with --seq2seq: a beam-search request instead")
    args = ap.parse_args(argv)
    small = args.bert or args.encoder_bias      # BERT-base's batch
    seq = args.seq or (128 if small else 8192 if args.longseq else 1024)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_gpt: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPT, Bert, bert_base,
                                         bert_pretrain_loss, gpt2_345m,
                                         gpt_loss, gpt_tiny)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as sched_lr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # bench.py's GPT-2 legs run remat=False (bench.py:299, :345)
    cfg = gpt2_345m(max_seq_len=seq, remat=args.remat)
    if args.longseq:
        cfg = gpt_tiny(num_layers=4, hidden_size=1024, num_heads=8,
                       vocab_size=8192, max_seq_len=seq, remat=True)
    micro = 2 if args.train and args.fused else 1
    batch = micro * (args.batch or (128 if small else 1 if args.longseq
                                    else 8))
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)), device="cuda")
    training = args.train or small or args.longseq
    beam_steps = None
    if args.seq2seq:
        # the composition lives in chip_smoke.py (the JAX package has no
        # seq2seq model class, so neither has the port)
        import chip_smoke as cs
        import paddle_tpu_torch.nn as tnn
        from paddle_tpu_torch.optimizer import Adam
        from paddle_tpu_torch.ops.cuda import flash_attention as fa
        gen = torch.Generator(device="cuda").manual_seed(7)
        torch.manual_seed(0)
        s2s = cs.seq2seq_model(tnn, cs.S2S_V, cs.S2S_D, cs.S2S_HEADS,
                               cs.S2S_LAYERS, cs.S2S_FFN, cs.S2S_SRC,
                               dropout=0.1, generator=gen)
        training = not args.serve
        if args.serve:
            batch, seq = cs.SERVE_B, cs.MAX_STEP
            s2s.to(torch.bfloat16).eval()
            src, _, _, bias = (torch.as_tensor(a, device="cuda") for a in
                               cs.seq2seq_batch(cs.S2S_V, batch, cs.S2S_SRC,
                                                cs.S2S_TGT))
            beam_steps = cs.MAX_STEP

            def serve():
                return cs.beam_request(tnn, fa, s2s, src, bias, cs.BEAM,
                                       cs.MAX_STEP)[1]

            requests = {"seq2seq_beam_request": serve}
        else:
            batch, seq = cs.S2S_B, cs.S2S_TGT
            sched = sched_lr.NoamDecay(cs.S2S_D, 4000, learning_rate=2.0)
            step = TrainStep(s2s, cs.seq2seq_loss,
                             Adam(learning_rate=sched, beta2=0.98,
                                  epsilon=1e-9),
                             amp_level="O2", amp_dtype="bfloat16")
            inputs = cs.seq2seq_inputs(tnn, cs.seq2seq_batch(
                cs.S2S_V, batch, cs.S2S_SRC, seq), "cuda")

            def train_step():
                loss = step(*inputs)
                sched.step()
                return loss

            requests = {"seq2seq_train_step": train_step}
    elif args.encoder_bias:
        import paddle_tpu_torch.nn as tnn
        enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
            768, 12, 3072, dropout=0.0, activation="gelu"), 12)
        enc.register_parameter("attn_bias", torch.nn.Parameter(
            torch.zeros(1, 12, seq, seq, device="cuda")))

        def mse(m, x, target):
            return (m(x, m.attn_bias).float() - target.float()).pow(2).mean()

        gen = torch.Generator(device="cuda").manual_seed(0)
        x, target = (torch.randn(batch, seq, 768, generator=gen,
                                 device="cuda") for _ in range(2))
        step = TrainStep(enc, mse, AdamW(learning_rate=1e-4),
                         amp_level="O2", amp_dtype="bfloat16")
        requests = {"encoder_bias_train_step": lambda: step(x, target)}
    elif args.bert:
        # bench.py's batch: 15 % MLM labels, lengths in [S/2, S], the MLM
        # labels -100 on the padding
        # bench_bert's configuration: remat=True, the default (bench.py:214)
        bcfg = bert_base(max_seq_len=seq)
        rng = np.random.default_rng(0)
        b_ids = rng.integers(0, bcfg.vocab_size, (batch, seq))
        mlm = np.where(rng.random((batch, seq)) < 0.15, b_ids, -100)
        nsp = rng.integers(0, 2, (batch,))
        lens = rng.integers(seq // 2, seq + 1, (batch,))
        amask = np.arange(seq)[None, :] < lens[:, None]
        inputs = [torch.as_tensor(a, device="cuda") for a in (
            b_ids, np.where(amask, mlm, -100), nsp, amask.astype(np.int32))]
        step = TrainStep(Bert(bcfg, device="cuda"), bert_pretrain_loss,
                         AdamW(learning_rate=1e-4), amp_level="O2",
                         amp_dtype="bfloat16")
        requests = {"bert_train_step_padded": lambda: step(*inputs)}
    elif args.train and args.fused:
        set_flags({"gpt_fused_ce": True})
        sched = sched_lr.LinearWarmup(
            sched_lr.CosineAnnealingDecay(1.5e-4, T_max=100),
            warmup_steps=2, start_lr=1.5e-5, end_lr=1.5e-4)
        opt = AdamW(learning_rate=sched, weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0), use_fused=True)
        step = TrainStep(GPT(cfg, device="cuda"), gpt_loss, opt,
                         amp_level="O2", amp_dtype="bfloat16",
                         accumulate_steps=micro)

        def train_step():
            loss = step(ids, ids)
            sched.step()
            return loss

        requests = {"train_fused_step": train_step}
    elif args.train or args.longseq:
        step = TrainStep(GPT(cfg, device="cuda"), gpt_loss,
                         AdamW(learning_rate=1e-4), amp_level="O2",
                         amp_dtype="bfloat16", recompute=args.recompute)
        name = "longseq_train_step" if args.longseq else "train_step"
        requests = {name: lambda: step(ids, ids)}
    else:
        model = GPT(cfg, device="cuda").to(torch.bfloat16)

        def loss(fused):
            set_flags({"gpt_fused_ce": fused})
            return gpt_loss(model, ids, ids)

        requests = {"logits": lambda: model(ids),
                    "loss_unfused": lambda: loss(False),
                    "loss_fused": lambda: loss(True)}
    # serving records no tape; training needs it
    with contextlib.nullcontext() if training else torch.inference_mode():
        for fn in requests.values():      # builds the kernels, warms up
            fn()
            fn()
        results = {name: _request(fn, args.reps)
                   for name, fn in requests.items()}
    for name, (wall, traced, groups, busy, top, host, gc_run) in \
            results.items():
        print(json.dumps({
            "request": name, "batch": batch, "seq": seq,
            "options": {k: v for k, v in vars(args).items()
                        if v is True},
            "wall_ms": wall, "tokens_per_s": batch * seq / wall
            * 1e3, "traced_wall_ms": traced, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / traced),
            "device_ms_by_group": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "count": n, "name": k}
                            for ms, n, k in top],
            "host_ms_by_range": host, "gc_per_run": gc_run,
            **({} if beam_steps is None else
               {"beam_step_ms": wall / beam_steps})}), flush=True)
    set_flags({"gpt_fused_ce": False})
    return 0


if __name__ == "__main__":
    sys.exit(main())
