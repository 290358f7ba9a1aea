"""JAX-free pieces of ``test_torch_elastic``: the MLP, its loss, the data
stream and the gloo worker of the 4 -> 3 shrink, which the worker
processes import (they load no JAX).

``gloo_worker(root, wid, world0, leave_after, steps)``: one rank of a
data-parallel job over ``torch.distributed`` (gloo) on an elastic
``FileStore`` under ``root``.  Each step every rank takes its
``dp_shard`` of the global batch, the gradients cross as the weighted
mean over the ranks, and rank 0 commits a ``TrainEpochRange`` slot every
2nd step.  After step ``leave_after`` worker ``w3`` leaves the store and
exits; the survivors see the epoch move, ``reform()`` (role refresh from
the store, restore of the latest committed slot), open a new process
group at the new world size and train on.  Each survivor writes its
final parameters to ``<root>/<wid>.json``."""
import json
import os
import sys
import time

import numpy as np
import torch


class MLP(torch.nn.Module):
    def __init__(self):
        from paddle_tpu_torch import nn
        super().__init__()
        self.fc1 = nn.Linear(6, 12, device="cpu")
        self.fc2 = nn.Linear(12, 3, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def mlp_loss(model, x, y):
    from paddle_tpu_torch.nn import functional as F
    return F.cross_entropy(model(x), y).mean()


def stream(n_steps, B=12):
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((B, 6)).astype("float32"),
             rng.integers(0, 3, size=(B,)).astype("int64"))
            for _ in range(n_steps)]


def weights_file(root):
    return os.path.join(root, "init.npz")


def gloo_worker(root, wid, world0, leave_after, steps):
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.distributed.fleet.role_maker import \
        PaddleCloudRoleMaker
    from paddle_tpu_torch.framework.auto_checkpoint import TrainEpochRange
    from paddle_tpu_torch.jit import TrainStep, loss_and_grads, loss_closure
    from paddle_tpu_torch.models import load_named_params
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel.mesh import DistGroup, mean_over

    store = elastic.FileStore(os.path.join(root, "rdv.json"), ttl=60.0)
    ctx = elastic.ElasticWorkerContext(store, wid, endpoint=wid + ":0",
                                       renew_interval=0.0)
    ctx.join()
    while len(store.members()) < world0:
        time.sleep(0.02)
    model = MLP()
    load_named_params(model, dict(np.load(weights_file(root))))
    opt = Momentum(learning_rate=0.05, momentum=0.9)
    container = TrainStep(model, mlp_loss, opt, donate=False)
    params = dict(model.named_parameters())
    container._opt_states = opt.functional_init_states(
        {n: p.detach() for n, p in params.items()})
    rm = PaddleCloudRoleMaker(is_collective=True)
    data = stream(steps)
    ck = os.path.join(root, "ck")
    loss_from = loss_closure(model, mlp_loss)

    def form(epoch):
        rm.refresh(store=store, worker_id=wid)
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(root, f"pg{epoch}"),
            rank=rm.worker_index(), world_size=rm.worker_num())
        return DistGroup(None)

    ctx.resync()
    group = form(store.epoch())
    epoch_range = TrainEpochRange(steps, "gloo-job", train_step=container,
                                  checkpoint_dir=ck, world_size=world0)
    t, reformed = 0, 0
    while t < steps:
        if ctx.membership_changed():
            dist.destroy_process_group()
            epoch, _, _, restored = elastic.reform(
                store, rm, wid, train_step=container, checkpoint_dir=ck)
            ctx.resync(epoch)
            group = form(epoch)
            t = 0 if restored is None else restored + 1
            reformed += 1
            continue
        X, Y = (torch.from_numpy(a) for a in data[t])
        world = rm.worker_num()
        sl = elastic.dp_shard(X.shape[0], world, rm.worker_index())
        _, g = loss_and_grads(loss_from, params, [X[sl], Y[sl]])
        scale = (sl.stop - sl.start) / X.shape[0] * world
        g = {n: mean_over(group, v * scale) for n, v in g.items()}
        with torch.no_grad():
            new_p, container._opt_states = opt.functional_update(
                {n: p.detach() for n, p in params.items()}, g,
                container._opt_states,
                lr=torch.tensor(opt.get_lr(), dtype=torch.float32))
            for n, p in params.items():
                p.copy_(new_p[n])
        dist.barrier()
        if t % 2 == 0 and rm.worker_index() == 0:
            epoch_range.save_checkpoint(t)
        dist.barrier()
        ctx.step_done(t)
        if t == leave_after:
            if wid == "w3":
                dist.destroy_process_group()
                store.leave(wid)
                return
            while len(store.members()) == world0:
                time.sleep(0.02)
        t += 1
    with open(os.path.join(root, wid + ".json"), "w") as f:
        json.dump({"params": {n: p.detach().numpy().tolist()
                              for n, p in model.named_parameters()},
                   "reformed": reformed, "world": rm.worker_num()}, f)
    dist.destroy_process_group()
    store.leave(wid)


if __name__ == "__main__":
    a = sys.argv[1:]
    gloo_worker(a[0], a[1], int(a[2]), int(a[3]), int(a[4]))
