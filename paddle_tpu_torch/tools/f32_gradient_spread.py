"""How far the f32 training-mode gradients of the port's ResNets sit from the
f64 gradients of the same model and batch.

    python -m paddle_tpu_torch.tools.f32_gradient_spread --device cpu
    python -m paddle_tpu_torch.tools.f32_gradient_spread --device cpu \\
        --model resnet50 --batch 2 --seeds 1 --steps 1

For each seed the model is drawn from ``torch.manual_seed(seed)`` and one
batch (standard normal images, integer labels) from
``numpy.random.default_rng(seed)``; each of ``--steps`` states is followed
by an SGD step of the f32 model at lr 1e-3.  At each state the f64 copy
gets the f32 model's parameters and buffers, both run one training-mode
forward and backward, and the tool prints one JSON line: the largest and
the median over the parameters of ``max |g32 - g64| / (|g64| +
rms(g64))``.  A last line counts the states whose largest reading passes
1e-3.  Two f32 implementations of a ReLU network round differently, and
a pre-activation within that rounding of 0 takes the other side of the
kink; this tool measures how often that moves the gradients, and by how
much, within the port alone.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys


def _spread(g32, g64):
    scale = g64.abs() + g64.pow(2).mean().sqrt()
    return float(((g32.double() - g64).abs() / scale.clamp_min(1e-300)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--model", default="resnet18",
                    choices=("resnet18", "resnet50"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.vision import models

    dev = resolve_device(args.device)
    make = getattr(models, args.model)
    flipped = 0
    for seed in range(args.seeds):
        torch.manual_seed(seed)
        m32 = make(num_classes=10, device=dev)
        m64 = make(num_classes=10, device=dev).double()
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(rng.standard_normal(
            (args.batch, 3, args.size, args.size)).astype(np.float32),
            device=dev)
        y = torch.as_tensor(rng.integers(0, 10, size=(args.batch,)),
                            device=dev)
        for step in range(args.steps):
            m64.load_state_dict(m32.state_dict())
            for m, xx in ((m32, x), (m64, x.double())):
                m.zero_grad()
                cross_entropy(m(xx), y).mean().backward()
            errs = sorted(_spread(p.grad, q.grad) for p, q in
                          zip(m32.parameters(), m64.parameters()))
            flipped += errs[-1] > 1e-3
            print(json.dumps({"model": args.model, "seed": seed,
                              "step": step, "max": errs[-1],
                              "median": errs[len(errs) // 2]}), flush=True)
            with torch.no_grad():
                for p in m32.parameters():
                    p -= 1e-3 * p.grad
    print(json.dumps({"states": args.seeds * args.steps,
                      "states_above_1e-3": flipped}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
