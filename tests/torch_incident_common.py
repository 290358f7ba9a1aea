"""Shared set-up of the port's postmortem tests (``test_torch_incident``,
``test_torch_resilient``): the reference's two-branch replay builder
(``tools/health_check.py build_incident_step``) and the port's copy of
it, which starts from the reference builder's weights (same seed), so a
bundle of either package replays through its own tool on the same
model.  ``port_build_incident_step`` is the port bundles' program
descriptor (``torch_incident_common:port_build_incident_step``)."""
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)


def reference_weights(seed: int = 0) -> dict:
    """The reference builder's initial parameters, by name."""
    import health_check
    step = health_check.build_incident_step(seed=seed)
    return {n: np.asarray(p._data)
            for n, p in step.step.model.named_parameters()}


class TwoBranch(torch.nn.Module):
    """The port's copy of the reference's ``_TwoBranch``: a linear layer
    on x and a (4,) parameter weighting z."""

    def __init__(self):
        from paddle_tpu_torch import nn
        super().__init__()
        self.fc = nn.Linear(8, 4, device="cpu")
        self.aux_w = torch.nn.Parameter(torch.full((4,), 0.1))

    def forward(self, x, z):
        return self.fc(x), (self.aux_w * z).sum()


def two_branch_loss(m, x, z, y):
    out, aux = m(x, z)
    return ((out - y) ** 2).mean() + 1e-3 * aux


def port_build_incident_step(seed: int = 0, lr: float = 0.05,
                             max_consecutive_bad: int = 3):
    """The port's replay builder: the resilient-wrapped two-branch step
    from the reference builder's weights; registers itself as the
    process's program descriptor."""
    from paddle_tpu_torch.framework import incident
    from paddle_tpu_torch.framework.resilient import ResilientTrainStep
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import load_named_params
    from paddle_tpu_torch.optimizer import SGD
    net = TwoBranch()
    load_named_params(net, reference_weights(seed))
    incident.set_program("torch_incident_common:port_build_incident_step",
                         seed=int(seed), lr=float(lr),
                         max_consecutive_bad=int(max_consecutive_bad))
    return ResilientTrainStep(
        TrainStep(net, two_branch_loss, SGD(learning_rate=float(lr))),
        max_consecutive_bad=int(max_consecutive_bad))


def batch(seed: int = 0):
    """(x, z, y) as numpy arrays: the reference test's batch."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((16, 8)).astype(np.float32),
            rng.standard_normal((4,)).astype(np.float32),
            rng.standard_normal((16, 4)).astype(np.float32))
