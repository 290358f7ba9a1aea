"""``framework.chaos`` of the port against the reference on the CPU, and the
fault points the port's steps consult:

- for the same spec and seed a point fires on the same calls in both
  packages (``nth``, ``every`` with ``n_times``, seeded ``p``, their mix),
  with the same counters and ``chaos.trip`` flight events; the arming from
  ``FLAGS_chaos_spec`` / ``FLAGS_chaos_seed``; ``latency``; an unknown
  point or ``nan`` on a point without a payload refused; a mid-sequence
  ``arm_state`` of either package resumed by the other;
- ``mode="nan"`` poisons a torch tensor on its own device and in its own
  dtype (a meta tensor stays meta: no host round trip), only the
  ``payload_index``-th element, as the reference poisons its arrays;
- ``zero.collective`` armed ``nth=1`` on ``ShardedUpdateTrainStep`` at
  dp = 2 (``LoopbackWorld`` threads) gives the unarmed step's bits with
  one counted retry; retries run out into ``zero.collective_failed``;
- ``ps.pipeline`` armed on ``PSTrainStep``'s prefetch: the failed
  prefetch's push is replayed and the rows pulled synchronously, so every
  gradient reaches the table once, in the unarmed run's order and bits,
  and the losses and dense parameters are the unarmed run's bitwise.  (A
  synchronous pull sees one push more than the prefetch it replaces, as
  in the reference, so the table's learning rate is 0 here: the rows stay
  the same in both runs.)"""
import copy
import json

import numpy as np
import pytest
import torch

from torch_planes_common import BOTH, PORT, REF, clean_planes

SCHEDULES = [{"nth": 3}, {"every": 2, "n_times": 3}, {"p": 0.3},
             {"every": 4, "nth": 2, "p": 0.15, "n_times": 5}]


def _fire(pkg, point, calls):
    trips = []
    for i in range(calls):
        try:
            pkg.chaos.fault_point(point, meta={"i": i})
        except pkg.chaos.InjectedFault:
            trips.append(i)
    return trips


@pytest.mark.parametrize("spec", SCHEDULES,
                         ids=lambda s: "-".join(f"{k}{v}"
                                                for k, v in s.items()))
def test_points_fire_on_the_same_calls(spec):
    got = []
    with clean_planes():
        for pkg in BOTH:
            pkg.chaos.reset(seed=7)
            with pkg.chaos.inject("ps.rpc", mode="error", **spec):
                trips = _fire(pkg, "ps.rpc", 40)
                stats = pkg.chaos.stats()
            events = [(e["attrs"]["point"], e["attrs"]["call"],
                       e["attrs"]["meta"]) for e in pkg.obs.flight.recent(
                           100, kind="chaos.trip")]
            got.append((trips, stats, events))
    assert got[1] == got[0]
    assert got[1][0], "the schedule never fired"


def test_flag_arming_latency_and_refusals():
    spec = json.dumps({"zero.collective": {"mode": "error", "every": 3},
                       "health.detector": {"mode": "latency",
                                           "latency": 0.01, "nth": 1}})
    got = []
    with clean_planes({"chaos_spec": spec, "chaos_seed": 3}):
        for pkg in BOTH:
            pkg.chaos.arm_from_flags(force=True)
            trips = _fire(pkg, "zero.collective", 10)
            assert pkg.chaos.fault_point("health.detector", "p") == "p"
            got.append((trips, pkg.chaos.stats()))
            with pytest.raises(ValueError, match="unknown fault point"):
                pkg.chaos.arm("no.such.point")
            with pytest.raises(ValueError, match="carries no payload"):
                pkg.chaos.arm("zero.collective", mode="nan")
            pkg.chaos.reset(0)
    assert got[1] == got[0] and got[1][0] == [2, 5, 8]


def test_arm_state_resumes_across_the_packages():
    """A schedule stopped mid-stream in one package resumes in the other
    on the same calls (seed, generator state and counters carried)."""
    with clean_planes():
        for src, dst in ((REF, PORT), (PORT, REF)):
            src.chaos.reset(seed=5)
            src.chaos.arm("ps.rpc", mode="error", p=0.4, n_times=8)
            head = _fire(src, "ps.rpc", 10)
            state = json.loads(json.dumps(src.chaos.arm_state()))
            tail_src = _fire(src, "ps.rpc", 20)
            dst.chaos.restore_state(state)
            assert _fire(dst, "ps.rpc", 20) == tail_src and head
            for pkg in BOTH:
                pkg.chaos.reset(0)


def test_nan_poison_keeps_device_and_dtype():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    ids = np.arange(4)
    with clean_planes():
        want = None
        for pkg in BOTH:
            with pkg.chaos.inject("train.step_grads", mode="nan", nth=1,
                                  payload_index=0):
                got = pkg.chaos.fault_point("train.step_grads",
                                            (x, ids, x))
            if want is None:
                want = got
        np.testing.assert_array_equal(got[0], want[0])     # NaN where the
        assert np.isnan(got[0][0, 0]) and got[2] is x       # reference's is
        assert got[1] is ids
        tensors = (torch.ones(2, 3, dtype=torch.bfloat16),
                   torch.ones(4, device="meta"),
                   torch.arange(3), torch.ones(2, 2).t())
        with PORT.chaos.inject("train.step_grads", mode="nan", nth=1):
            out = PORT.chaos.fault_point("train.step_grads", tensors)
    assert isinstance(out, tuple) and out[2] is tensors[2]
    assert out[0].dtype == torch.bfloat16 and torch.isnan(out[0][0, 0])
    assert not torch.isnan(out[0]).view(-1)[1:].any()
    assert out[1].device.type == "meta"
    assert torch.isnan(out[3]).sum() == 1
    assert not torch.isnan(tensors[0]).any()          # the input untouched


# -- the steps' fault points -------------------------------------------------
def _mlp(seed):
    import paddle_tpu_torch.nn as tnn
    torch.manual_seed(seed)
    return tnn.Sequential(tnn.Linear(6, 16, device="cpu"), tnn.ReLU(),
                          tnn.Linear(16, 1, device="cpu"))


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _zero_run(init, batches, spec=None, retries=2):
    """ShardedUpdateTrainStep at dp = 2 on LoopbackWorld threads: every
    rank's losses and final parameters."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import LoopbackWorld
    from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep

    def fn(rank, mesh):
        model = copy.deepcopy(init)
        step = ShardedUpdateTrainStep(model, _mse, AdamW(learning_rate=0.05),
                                      mesh=mesh, wire_dtype="f32",
                                      collective_retries=retries)
        losses = [step(torch.from_numpy(x), torch.from_numpy(y)).clone()
                  for x, y in batches]
        return losses, [p.detach().clone() for p in model.parameters()]
    if spec is None:
        return LoopbackWorld(2).run(fn)
    with PORT.chaos.inject("zero.collective", mode="error", **spec):
        return LoopbackWorld(2).run(fn)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((8, 6)).astype(np.float32),
             rng.standard_normal((8, 1)).astype(np.float32))
            for _ in range(n)]


def test_zero_collective_fault_is_retried_bitwise():
    init, batches = _mlp(0), _batches(3)
    with clean_planes():
        plain = _zero_run(init, batches)
    with clean_planes():
        armed = _zero_run(init, batches, {"nth": 1})
        stats = PORT.monitor.all_stats()
        trips = PORT.obs.flight.recent(10, kind="chaos.trip")
    for (la, pa), (lb, pb) in zip(plain, armed):
        assert all(torch.equal(a, b) for a, b in zip(la, lb))
        assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    # one controller's count: the lead rank consults the point
    assert stats["zero_collective_retries_total"] == 1
    assert [t["attrs"]["meta"] for t in trips] == [{"leg": "reduce_scatter"}]
    assert stats["train_steps_total"] == 3
    with clean_planes():
        with pytest.raises(PORT.chaos.InjectedFault):
            _zero_run(init, batches[:1], {"every": 1}, retries=2)
        failed = PORT.obs.flight.recent(10, kind="zero.collective_failed")
        assert PORT.monitor.get_stat("zero_collective_retries_total") == 3
    assert [(e["severity"], e["attrs"]) for e in failed] == [
        ("error", {"leg": "reduce_scatter", "attempts": 3})]


def _ps_run(spec=None):
    """5 prefetched PSTrainStep steps over a frozen (lr 0) sgd table: the
    losses, the dense parameters and every push that reached the table."""
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.models import WideDeepHost
    from paddle_tpu_torch.optimizer import Adam
    torch.manual_seed(0)
    emb = ps.DistributedEmbedding(200, 5, optimizer="sgd", learning_rate=0.0,
                                  mode="sync", seed=0, device="cpu")
    pushes = []
    push = emb.table.push
    emb.table.push = lambda ids, g, lr=None: (
        pushes.append((ids.copy(), g.copy())), push(ids, g))
    model = WideDeepHost(embedding_dim=4, num_fields=3, dense_dim=2,
                         hidden=(8,), device="cpu")

    def loss_fn(m, rows, x, y):
        return torch.nn.functional.binary_cross_entropy_with_logits(
            m(rows, x), y).mean()
    step = ps.PSTrainStep(model, loss_fn, Adam(learning_rate=1e-2), emb,
                          prefetch_depth=1, device="cpu")
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 40, (5, 16, 3))
    xs = torch.from_numpy(rng.standard_normal((5, 16, 2)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 2, (5, 16, 1)).astype(np.float32))
    losses = []
    step.prefetch(ids[0])
    if spec is not None:
        PORT.chaos.arm("ps.pipeline", mode="error", **spec)
    for n in range(5):
        if n + 1 < 5:
            step.prefetch(ids[n + 1])
        losses.append(step(ids[n], xs[n], ys[n]))
    step.flush()
    PORT.chaos.disarm()
    return losses, [p.detach() for p in model.parameters()], pushes


def test_ps_pipeline_fault_falls_back_bitwise():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with clean_planes():
            plain = _ps_run()
            base = dict(PORT.monitor.all_stats())
        with clean_planes():
            armed = _ps_run({"nth": 2})
            stats = PORT.monitor.all_stats()
            trips = PORT.obs.flight.recent(10, kind="chaos.trip")
    finally:
        torch.use_deterministic_algorithms(was)
    assert all(torch.equal(a, b) for a, b in zip(plain[0], armed[0]))
    assert all(torch.equal(a, b) for a, b in zip(plain[1], armed[1]))
    assert len(plain[2]) == len(armed[2]) == 5
    for (ia, ga), (ib, gb) in zip(plain[2], armed[2]):
        assert np.array_equal(ia, ib) and np.array_equal(ga, gb)
    assert [t["attrs"]["meta"] for t in trips] == [
        {"n_ids": 48, "coalesced_push": True}]
    assert (base["ps_prefetch_hits_total"],
            base.get("ps_prefetch_misses_total", 0)) == (4, 0)
    assert (stats["ps_prefetch_hits_total"],
            stats["ps_prefetch_misses_total"]) == (3, 1)
    assert stats["train_steps_total"] == 5
