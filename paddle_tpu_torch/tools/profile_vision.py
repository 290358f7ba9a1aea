"""Where the time of a ResNet-50 (or YOLOv3-DCN) training step goes on
the card.

    python -m paddle_tpu_torch.tools.profile_vision [--batch 128] [--size 224]
    python -m paddle_tpu_torch.tools.profile_vision --yolov3 [--batch 8]

Builds ``resnet50(num_classes=1000)`` (NCHW, f32 masters) on the card and
trains it as bench.py's ``bench_resnet50`` does: ``TrainStep`` with AMP O2
bf16, ``Momentum(0.1, 0.9)``, ``cross_entropy(...).mean()``, inputs from
``default_rng(0)``.  After two warm-up steps it prints the card's name and
power limit (nvidia-smi), then one JSON line for one traced step: the wall
time between synchronisations (mean of a few untraced steps), the device
time of its kernels by group, the device's busy and idle share of the
traced wall time, and the kernels that took most device time.

``--yolov3``: one eager step of chip_smoke.py's yolov3-dcn composition
(resnet50 with DCNv2 in layer4, the YOLOv3 FPN, 80 classes; run from the
repository's root) on its batch (B=8 at 608x608, f32), ``Momentum(1e-3,
0.9)`` with ``L2Decay(5e-4)``: the deformable convolutions, the upsampling
and the three ``yolo_loss`` heads get groups of their own, the optimizer's
``step`` is the update.

Groups: each module kind's forward runs inside a profiler range the tool
opens (convolution, batch norm, pooling, ReLU, the linear head, the loss);
a backward kernel takes the group of the forward op whose autograd node
launched it (the profiler's sequence numbers).  Kernels inside the
``TrainStep.update`` range are the Momentum update; the rest are the O2
casts and copies, or elementwise work outside the modules (the residual
adds).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

_UPDATE_RANGE = "TrainStep.update"
_RANGES = {"Conv2D": "convolution", "BatchNorm2D": "batch norm",
           "MaxPool2D": "pooling", "AdaptiveAvgPool2D": "pooling",
           "ReLU": "relu", "LeakyReLU": "relu", "Linear": "linear head",
           "DeformConv2D": "deformable convolution"}
_LOSS_RANGE = "loss"


def _ranged(module, name):
    """module.forward inside a profiler range called ``name``."""
    import torch
    forward = module.forward

    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return forward(*args, **kwargs)
    module.forward = run


def _range_of(evt, names):
    while evt is not None:
        if evt.name in names:
            return evt.name
        evt = evt.cpu_parent
    return None


def _node_seq(evt):
    """The sequence number of the autograd node an event runs under, or
    None outside the backward."""
    while evt is not None:
        if "Backward" in evt.name and evt.sequence_nr >= 0:
            return evt.sequence_nr
        evt = evt.cpu_parent
    return None


def profile_step(fn, reps: int):
    """(mean wall ms, traced wall ms, {group: device ms}, busy ms, top
    kernels) of one call of fn()."""
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
    names = set(_RANGES.values()) | {_LOSS_RANGE, _UPDATE_RANGE}
    events = prof.events()
    fwd_group = {}                    # forward op's sequence number -> group
    for evt in events:
        if evt.sequence_nr >= 0 and _node_seq(evt) is None:
            group = _range_of(evt, names)
            if group is not None:
                fwd_group.setdefault(evt.sequence_nr, group)
    groups, kernels = {}, {}
    for evt in events:
        if not evt.kernels:
            continue
        rng = _range_of(evt, names)
        seq = _node_seq(evt)
        if rng == _UPDATE_RANGE:
            group = "Momentum update"
        elif seq is not None:
            group = fwd_group.get(seq, "other") + " (backward)"
        elif rng is not None:
            group = rng + " (forward)"
        elif "copy" in evt.name or evt.name in ("aten::to", "aten::_to_copy"):
            group = "casts and copies"
        else:
            group = "other"
        for k in evt.kernels:
            ms = k.duration / 1e3
            if group == "other" and "copy" in k.name.lower():
                g = "casts and copies"
            elif group == "other":
                g = "elementwise outside the modules (residual adds)"
            else:
                g = group
            groups[g] = groups.get(g, 0.0) + ms
            kernels[k.name] = kernels.get(k.name, 0.0) + ms
    busy = sum(groups.values())
    top = sorted(((ms, name[:90]) for name, ms in kernels.items()),
                 reverse=True)[:10]
    return wall_ms, traced_ms, groups, busy, top


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--yolov3", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_vision: no CUDA device", file=sys.stderr)
        return 2
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.yolov3:
        return _yolov3(args)
    model = resnet50(num_classes=1000)
    for m in model.modules():
        if type(m).__name__ in _RANGES:
            _ranged(m, _RANGES[type(m).__name__])

    def loss_fn(m, x, y):
        logits = m(x)
        with torch.profiler.record_function(_LOSS_RANGE):
            return F.cross_entropy(logits, y).mean()

    step = TrainStep(model, loss_fn, Momentum(learning_rate=0.1,
                                              momentum=0.9),
                     amp_level="O2", amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    b, hw = args.batch or 128, args.size or 224
    x = torch.as_tensor(rng.standard_normal((b, 3, hw, hw)).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, size=(b,)), device="cuda")
    for _ in range(2):
        step(x, y)
    wall, traced, groups, busy, top = profile_step(lambda: step(x, y),
                                                   args.reps)
    print(json.dumps({
        "request": "resnet50_train_step", "batch": b, "size": hw,
        "wall_ms": wall, "samples_per_s": b / wall * 1e3,
        "traced_wall_ms": traced, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / traced),
        "device_ms_by_group": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
        "top_kernels": [{"ms": ms, "name": k} for ms, k in top]}),
        flush=True)
    return 0


def _yolov3(args) -> int:
    """--yolov3: the profile of one eager yolov3-dcn step."""
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision import ops
    from paddle_tpu_torch.vision.models import resnet50
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, hw = args.batch or cs.YOLO_B, args.size or cs.YOLO_HW
    model = cs.yolov3_dcn(tnn, tnn.functional, ops, resnet50,
                          cs.YOLO_CLASSES)
    for m in model.modules():
        if type(m).__name__ in _RANGES:
            _ranged(m, _RANGES[type(m).__name__])
    opt = Momentum(learning_rate=cs.YOLO_LR, momentum=0.9,
                   parameters=model.parameters(),
                   weight_decay=L2Decay(cs.YOLO_DECAY))
    x, box, label = (torch.as_tensor(a, device="cuda") for a in
                     cs.yolo_batch(b, hw, cs.YOLO_CLASSES))

    def step():
        outs = model(x)
        with torch.profiler.record_function(_LOSS_RANGE):
            loss = cs.yolo_loss_sum(ops, outs, box, label, cs.YOLO_CLASSES)
        loss.backward()
        with torch.profiler.record_function(_UPDATE_RANGE):
            opt.step()
            opt.clear_grad()
    for _ in range(2):
        step()
    wall, traced, groups, busy, top = profile_step(step, args.reps)
    groups = {k.replace("Momentum update", "Momentum + L2 update"): v
              for k, v in groups.items()}
    print(json.dumps({
        "request": "yolov3_dcn_train_step", "batch": b, "size": hw,
        "wall_ms": wall, "images_per_s": b / wall * 1e3,
        "traced_wall_ms": traced, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / traced),
        "device_ms_by_group": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
        "top_kernels": [{"ms": ms, "name": k} for ms, k in top]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
