"""The port's replica-parity probe (paddle_tpu_torch/parallel/parity.py)
against the reference's (paddle_tpu/parallel/parity.py) on the CPU.

The device hash (``leaf_hash_device``: int64 arithmetic on 16-bit halves)
is held bitwise to both packages' ``leaf_hash_host`` and to the
reference's traced hash on f32, bf16, f16, f64, int32, int64, uint8 and
bool leaves from a numpy seed, across the chunk seam.  A dp = 2 world
whose ``w2`` differs on rank 1 (the reference: a shard_map output that
claims replication; the port: ``LoopbackWorld`` ranks) gives the same
(replicas, leaves) hash matrix in both and names ``w2`` in both.  The
probe's cadence, chaos point and counters follow the reference's, and in
``ShardedUpdateTrainStep`` at dp = 2 an armed run is bitwise the
disarmed one; a single bit flipped in rank 1's copy of one leaf is named.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from paddle_tpu.parallel import parity as jpar
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.parallel.mesh import shard_map_compat
from paddle_tpu_torch.parallel import LoopbackWorld
from paddle_tpu_torch.parallel import parity as tpar

from torch_planes_common import PORT, clean_planes

DTYPES = ("float32", "bfloat16", "float16", "float64", "int32", "int64",
          "uint8", "bool")


def _leaf(dtype, n, seed=0):
    """A numpy array (bf16 as its uint16 words) and the torch tensor of
    the same bits."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        a = rng.integers(0, 2, n).astype(bool)
    elif dtype in ("int32", "int64", "uint8"):
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, n, dtype=dtype)
    elif dtype == "bfloat16":
        a = rng.integers(0, 1 << 16, n, dtype=np.uint16)
        return a, torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        a = (rng.standard_normal(n) * 1e3).astype(dtype)
    return a, torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_device_hash_is_the_host_hash_bitwise(dtype, monkeypatch):
    """The port's device hash of a leaf equals both packages'
    ``leaf_hash_host`` and the reference's traced hash, bitwise; across
    a chunk seam too (the chunk cut to 1000 elements)."""
    a, t = _leaf(dtype, 5003)
    want = jpar.leaf_hash_host(a)
    jx = jnp.asarray(a).view(jnp.bfloat16) if dtype == "bfloat16" \
        else jnp.asarray(a)
    assert int(jax.jit(jpar._leaf_hash_traced)(jx)) == want
    assert tpar.leaf_hash_host(t) == want
    assert int(tpar.leaf_hash_device(t)) == want
    monkeypatch.setattr(tpar, "_CHUNK", 1000)
    assert int(tpar.leaf_hash_device(t)) == want
    assert int(tpar.leaf_hash_device(t[:0])) == jpar.leaf_hash_host(a[:0])


def test_hash_of_large_words_and_a_single_bit():
    """Words near 2^32 times weights near 2^20 (the products the 16-bit
    halves keep below 2^48), and one ulp moved changes the hash."""
    a = np.full(600_000, 0xFFFFFFFF, np.uint32).view(np.float32)
    t = torch.from_numpy(a.copy())
    assert int(tpar.leaf_hash_device(t)) == jpar.leaf_hash_host(a)
    b = np.arange(8, dtype=np.float32)
    b2 = b.copy()
    b2[3] = np.nextafter(b2[3], 2.0)
    assert tpar.leaf_hash_host(torch.from_numpy(b)) != \
        tpar.leaf_hash_host(torch.from_numpy(b2))


def _ref_divergent():
    mesh = jmake_mesh({"dp": 2}, devices=jax.devices()[:2])

    def mk():
        i = jax.lax.axis_index("dp")
        return jnp.full((4,), 1.0, jnp.float32) + i.astype(jnp.float32)
    w2 = jax.jit(shard_map_compat(mk, mesh=mesh, in_specs=(),
                                  out_specs=P()))()
    w1 = jax.device_put(jnp.ones(4, jnp.float32), NamedSharding(mesh, P()))
    return jpar.ParityProbe(mesh=mesh).check({"w1": w1, "w2": w2})


def test_divergent_leaf_named_alike():
    """dp = 2, w2 = 1 + rank on each replica, w1 replicated: the same
    hash matrix and the same divergent leaf in both packages."""
    want = _ref_divergent()

    def fn(rank, mesh):
        tree = {"w1": torch.ones(4), "w2": torch.full((4,), 1.0 + rank)}
        return tpar.ParityProbe(mesh=mesh).check(tree)
    got = LoopbackWorld(2).run(fn)
    for rec in got:
        assert rec.names == want.names == ["w1", "w2"]
        assert np.array_equal(rec.hashes, np.asarray(want.hashes))
        assert np.array_equal(rec.agree, np.asarray(want.agree))
        assert rec.divergent_leaves() == want.divergent_leaves() == ["w2"]


def test_observe_cadence_chaos_and_disarmed():
    """The every-K gate, the swallowed and counted chaos fault, the
    flight event naming the leaf, and nothing at all disarmed: the
    counters the reference's probe keeps in the same sequence."""
    def fn(rank, mesh):
        good = {"a": torch.ones(4)}
        bad = {"a": torch.ones(4), "b": torch.full((2,), float(rank))}
        probe = tpar.ParityProbe(mesh=mesh, every=2)
        cadence = [probe.observe(good) is not None for _ in range(4)]
        probe1 = tpar.ParityProbe(mesh=mesh, every=1)
        rec = probe1.observe(bad, step=7)
        return cadence, rec.first_divergent_leaf()
    with clean_planes({"replica_parity": True}):
        got = LoopbackWorld(2).run(fn)
        assert got[0] == got[1] == ([False, True, False, True], "b")
        assert PORT.monitor.get_stat("parity_checks_total") == 3
        assert PORT.monitor.get_stat("parity_divergence_total") == 1
        ev = PORT.obs.flight.recent(4, kind="parity.divergence")
        assert ev[-1]["attrs"]["first_bad_leaf"] == "b"
        assert ev[-1]["attrs"]["step"] == 7

        def faulty(rank, mesh):
            probe = tpar.ParityProbe(mesh=mesh, every=1)
            return probe.observe({"a": torch.ones(4)})
        with PORT.chaos.inject("parity.observe", mode="error", every=1):
            assert LoopbackWorld(2).run(faulty) == [None, None]
        assert PORT.monitor.get_stat("parity_observe_errors_total") == 2
        assert PORT.monitor.get_stat("parity_checks_total") == 3
    with clean_planes({"replica_parity": False}):
        def off(rank, mesh):
            return tpar.ParityProbe(mesh=mesh, every=1).observe(
                {"a": torch.full((2,), float(rank))})
        assert LoopbackWorld(2).run(off) == [None, None]
        assert not PORT.monitor.get_stat("parity_checks_total")


def _zero_run(armed, flip=None, steps=3):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep
    torch.manual_seed(0)
    proto = nn.Sequential(nn.Linear(6, 12, device="cpu"), nn.ReLU(),
                          nn.Linear(12, 3, device="cpu"))
    state = proto.state_dict()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))

    def fn(rank, mesh):
        m = nn.Sequential(nn.Linear(6, 12, device="cpu"), nn.ReLU(),
                          nn.Linear(12, 3, device="cpu"))
        m.load_state_dict(state)
        step = ShardedUpdateTrainStep(
            m, lambda mm, a, b: ((mm(a) - b) ** 2).mean(),
            Momentum(learning_rate=0.05, momentum=0.9), mesh=mesh,
            wire_dtype="f32")
        losses = [float(step(x, y)) for _ in range(steps)]
        if flip is not None:
            # the planted fault: one bit of rank 1's copy, then a probe
            # (the next step's all-gather would heal it)
            if rank == 1:
                with torch.no_grad():
                    p = dict(m.named_parameters())[flip]
                    p.view(-1)[0:1].view(torch.int32).bitwise_xor_(1)
            tpar.maybe_observe(step, mesh=mesh)
        return losses, {n: p.detach().clone()
                        for n, p in m.named_parameters()}
    with clean_planes({"replica_parity": armed,
                       "replica_parity_every": 1}):
        out = LoopbackWorld(2).run(fn)
        stats = (PORT.monitor.get_stat("parity_checks_total"),
                 PORT.monitor.get_stat("parity_divergence_total"),
                 PORT.obs.flight.recent(8, kind="parity.divergence"))
    return out, stats


def test_zero_step_armed_is_bitwise_and_names_a_flipped_bit():
    """ShardedUpdateTrainStep at dp = 2 (f32 wire): the armed run's losses
    and parameters are bitwise the disarmed run's and every step is
    checked with no divergence; one bit flipped in rank 1's copy of
    ``2.weight`` after the steps is named by the next probe."""
    clean, (c0, d0, _) = _zero_run(False)
    armed, (c1, d1, _) = _zero_run(True)
    assert not c0 and c1 == 3 and not d1
    for (la, pa), (lb, pb) in zip(clean, armed):
        assert la == lb
        for n in pa:
            assert torch.equal(pa[n], pb[n])
    _, (c2, d2, ev) = _zero_run(True, flip="2.weight")
    assert d2 == 1 and ev[-1]["attrs"]["first_bad_leaf"] == "2.weight"


def test_opt_leaf_names_are_the_references():
    """The optimizer leaves' names: the reference's ``"opt" +
    keystr(path)`` of the nested state, e.g. ``opt['fc.w']['moment1']``."""
    import jax.tree_util as jtu
    states = {"fc.w": {"moment1": np.zeros(2), "beta1_pow": np.zeros(())},
              "b": {"velocity": np.zeros(3)}}
    flat, _ = jtu.tree_flatten_with_path(states)
    want = sorted("opt" + jtu.keystr(p) for p, _ in flat)
    got = sorted(tpar._opt_leaves({k: {s: torch.from_numpy(v)
                                       for s, v in st.items()}
                                   for k, st in states.items()}))
    assert got == want
