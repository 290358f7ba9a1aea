"""How far the f32 training-mode gradients of the port's ResNets and of a
small DCGAN sit from the f64 gradients of the same model and batch.

    python -m paddle_tpu_torch.tools.f32_gradient_spread --device cpu
    python -m paddle_tpu_torch.tools.f32_gradient_spread --device cpu \\
        --model resnet50 --batch 2 --seeds 1 --steps 1
    python -m paddle_tpu_torch.tools.f32_gradient_spread --device cpu \\
        --model dcgan --batch 8 --seeds 20 --steps 1 [--eval] [--threads 1]

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

``--model dcgan`` is DCGAN (Radford et al., arXiv:1511.06434) at
ngf = ndf = 16 on 64 x 64 images (uniform in [-1, 1]) and z of 100
(standard normal): D's gradients of its loss on the real and the
detached fake batch, G's of D's verdict on the fake, through
binary_cross_entropy_with_logits.  ``--eval`` puts the batch norms in
evaluation mode on the running stats of one training forward of the f32
model (the f64 copy takes them too); ``--threads`` sets
``torch.set_num_threads``.  In training mode the port's batch norm keeps
f32 statistics in f64 as well (the reference's rule), so there the f64
gradients are a second rounding of the model, not an exact one.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def _spread(g32, g64):
    scale = g64.abs() + g64.pow(2).mean().sqrt()
    return float(((g32.double() - g64).abs() / scale.clamp_min(1e-300)).max())


def _dcgan(nn, dev, width=16, z=100):
    """(G, D) as chip_smoke.dcgan_models builds them: N(0, 0.02) weights,
    no bias where a BatchNorm2D follows."""
    def attr():
        return nn.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))
    w = [8 * width, 4 * width, 2 * width, width]
    g = [nn.Conv2DTranspose(z, w[0], 4, 1, 0, weight_attr=attr(),
                            bias_attr=False, device=dev),
         nn.BatchNorm2D(w[0], device=dev), nn.ReLU()]
    for cin, cout in zip(w, w[1:]):
        g += [nn.Conv2DTranspose(cin, cout, 4, 2, 1, weight_attr=attr(),
                                 bias_attr=False, device=dev),
              nn.BatchNorm2D(cout, device=dev), nn.ReLU()]
    g += [nn.Conv2DTranspose(width, 3, 4, 2, 1, weight_attr=attr(),
                             device=dev), nn.Tanh()]
    w.reverse()
    d = [nn.Conv2D(3, width, 4, 2, 1, weight_attr=attr(), device=dev),
         nn.LeakyReLU(0.2)]
    for cin, cout in zip(w, w[1:]):
        d += [nn.Conv2D(cin, cout, 4, 2, 1, weight_attr=attr(),
                        bias_attr=False, device=dev),
              nn.BatchNorm2D(cout, device=dev), nn.LeakyReLU(0.2)]
    d.append(nn.Conv2D(8 * width, 1, 4, weight_attr=attr(), device=dev))
    return nn.Sequential(nn.Sequential(*g), nn.Sequential(*d))


def _dcgan_grads(m, batch):
    """One iteration of the eager loop: D's gradients of its loss, an
    Adam(2e-4, beta1=0.5) step of D, then G's gradients of the stepped
    D's verdict on the fake; G's gradients first, as m.parameters()."""
    from paddle_tpu_torch.nn.functional import (
        binary_cross_entropy_with_logits as bce)
    from paddle_tpu_torch.optimizer import Adam
    g, d = m[0], m[1]
    real, z = batch
    ones = real.new_ones(len(real), 1, 1, 1)
    m.zero_grad()
    fake = g(z)
    (bce(d(real), ones)
     + bce(d(fake.detach()), torch.zeros_like(ones))).backward()
    out = [p.grad.clone() for p in d.parameters()]
    Adam(learning_rate=2e-4, beta1=0.5, parameters=d.parameters()).step()
    m.zero_grad()
    bce(d(fake), ones).backward()
    return [p.grad.clone() for p in g.parameters()] + out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--model", default="resnet18",
                    choices=("resnet18", "resnet50", "dcgan"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.vision import models

    if args.threads:
        torch.set_num_threads(args.threads)
    dev = resolve_device(args.device)
    flipped = 0
    for seed in range(args.seeds):
        torch.manual_seed(seed)
        rng = np.random.default_rng(seed)
        if args.model == "dcgan":
            m32, m64 = _dcgan(nn, dev), _dcgan(nn, dev).double()
            batch = [torch.as_tensor(a.astype(np.float32), device=dev)
                     for a in (rng.uniform(-1, 1, (args.batch, 3, 64, 64)),
                               rng.standard_normal((args.batch, 100, 1, 1)))]

            def grads(m, xs):
                return _dcgan_grads(m, xs)
        else:
            make = getattr(models, args.model)
            m32 = make(num_classes=10, device=dev)
            m64 = make(num_classes=10, device=dev).double()
            batch = [torch.as_tensor(rng.standard_normal(
                (args.batch, 3, args.size, args.size)).astype(np.float32),
                device=dev)]
            y = torch.as_tensor(rng.integers(0, 10, size=(args.batch,)),
                                device=dev)

            def grads(m, xs):
                m.zero_grad()
                cross_entropy(m(xs[0]), y).mean().backward()
                return [p.grad for p in m.parameters()]
        if args.eval:
            with torch.no_grad():
                if args.model == "dcgan":
                    m32[1](batch[0])
                    m32[1](m32[0](batch[1]))
                else:
                    m32(batch[0])
            m32.eval()
            m64.eval()
        for step in range(args.steps):
            m64.load_state_dict(m32.state_dict())
            g32 = grads(m32, batch)
            g64 = grads(m64, [b.double() for b in batch])
            errs = sorted(_spread(p, q) for p, q in zip(g32, g64))
            flipped += errs[-1] > 1e-3
            print(json.dumps({"model": args.model, "seed": seed,
                              "step": step, "max": errs[-1],
                              "median": errs[len(errs) // 2]}), flush=True)
            with torch.no_grad():
                for p, gr in zip(m32.parameters(), g32):
                    p -= 1e-3 * gr
    print(json.dumps({"states": args.seeds * args.steps,
                      "states_above_1e-3": flipped}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
