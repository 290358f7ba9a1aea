"""The port's ZeRO sharded update (paddle_tpu_torch/parallel/zero.py), its
replicated baseline (parallel/dp_meta.py) and the ring collectives
(parallel/ring.py), on gloo ranks spawned as processes, held to the
reference's contract (tests/test_zero.py):

- f32 ZeRO is BITWISE the replicated step at dp = 2 and dp = 4 over 6
  steps with Momentum and Adam: losses, parameters and moments; the ring
  at f32 is bitwise the unfused legs;
- the int8 / int4 ring primitives are bitwise the ring by its definition on
  the reference's numpy codec, and within an FMA's last bit of the JAX ring;
- f32 ZeRO at dp = 2 is within 1e-4 of the JAX ``ShardedUpdateTrainStep``
  on the 8-device CPU mesh, from the same weights (load_named_params);
- the bf16 and int8 wires drift by at most 2e-2 and 8e-2 of the f32 run,
  the bf16 / int8 / int4 rings by 2e-2 / 8e-2 / 4e-1, and still train; the
  int8 and int4 replicas stay bitwise equal;
- wire and optimizer-state bytes equal the reference's accounting.

Each world size runs in ONE spawn (a module fixture), whose ranks write
their readings to a file; the tests read them.  The JAX imports live in
the fixtures and tests that need them, so the spawned ranks import only
torch, numpy and the port.  In-process, the ranks simulated as threads
(``parallel.mesh.LoopbackWorld``, how chip_smoke.py runs dp = 2 on one
card) give the gloo ranks' bits."""
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm, Linear
from paddle_tpu_torch.optimizer import SGD, Adam, Momentum
from paddle_tpu_torch.parallel import init_process_group, make_mesh
from paddle_tpu_torch.parallel.dp_meta import CompressedAllReduceTrainStep
from paddle_tpu_torch.parallel.mesh import LoopbackWorld, Mesh
from paddle_tpu_torch.parallel.ring import ring_all_gather, ring_reduce_scatter
from paddle_tpu_torch.parallel.zero import (ShardedUpdateTrainStep,
                                            build_shard_specs)

STEPS = 6
DRIFT = {"bf16": 2e-2, "int8": 8e-2}      # reference test_zero.py:254


def _data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 7)).astype(np.float32)
    y = (x @ rng.standard_normal((7, 1))).astype(np.float32)
    return x, y


def _mlp(weights):
    """The reference's test MLP, uneven leaves: Linear(7, 33), ReLU,
    Linear(33, 1), with the given {dotted name: array} weights."""
    m = torch.nn.Sequential(Linear(7, 33, device="cpu"), torch.nn.ReLU(),
                            Linear(33, 1, device="cpu"))
    return load_named_params(m, weights)


def _loss_fn(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _opt(kind, m, **kw):
    if kind == "momentum":
        return Momentum(learning_rate=0.05, momentum=0.9,
                        parameters=m.parameters(), **kw)
    return Adam(learning_rate=0.05, parameters=m.parameters(), **kw)


def _params(m):
    return {n: p.detach().clone() for n, p in m.named_parameters()}


def _run(step, x, y, steps=STEPS):
    return [float(step(x, y)) for _ in range(steps)]


def _zero(weights, mesh, opt="momentum", wire="f32", chunk=8, ring=False,
          steps=STEPS, **okw):
    m = _mlp(weights)
    s = ShardedUpdateTrainStep(m, _loss_fn, _opt(opt, m, **okw), mesh=mesh,
                               wire_dtype=wire, chunk=chunk, ring=ring)
    x, y = _data()
    return {"losses": _run(s, x, y, steps), "params": _params(m),
            "states": s._opt_states, "step": s}


def _replicated(weights, mesh, opt):
    m = _mlp(weights)
    s = CompressedAllReduceTrainStep(m, _loss_fn, _opt(opt, m), mesh=mesh,
                                     compress_dtype="float32")
    x, y = _data()
    return {"losses": _run(s, x, y), "params": _params(m),
            "states": s._opt_states}


def _ring_input(dp):
    """(dp, dp * 24) f32: row r is rank r's vector, as in the reference's
    test_quantized_rs_tracks_exact_sum."""
    rng = np.random.default_rng(8)
    return torch.from_numpy(
        rng.standard_normal((dp, dp * 24)).astype(np.float32))


def _readings(weights, mesh):
    """Every check's numbers on one rank (all ranks run the same code)."""
    dp = mesh.shape["dp"]
    out = {}
    for opt in ("momentum", "adam"):
        z = _zero(weights, mesh, opt)
        z.pop("step")
        out[f"{opt}_zero"] = z
        out[f"{opt}_replicated"] = _replicated(weights, mesh, opt)
    ring = _zero(weights, mesh, "momentum", ring=True)
    out["ring_f32"] = {"losses": ring["losses"], "params": ring["params"]}
    for wire in ("int8", "int4"):
        for r in (False, True):
            q = _zero(weights, mesh, wire=wire, ring=r)
            out[f"{wire}_ring{int(r)}"] = {"losses": q["losses"],
                                           "params": q["params"]}
        # the ring primitives alone, on rank r's row of _ring_input(dp)
        s = ring_reduce_scatter(_ring_input(dp)[mesh.rank], mesh, chunk=8,
                                wire=wire)
        out[f"ring_rs_ag_{wire}"] = (s, ring_all_gather(s, mesh, chunk=8,
                                                        wire=wire))
    if dp == 2:
        for r in (0, 1):
            out[f"bf16_ring{r}"] = {"losses": _zero(
                weights, mesh, wire="bf16", ring=bool(r))["losses"]}
        out["int8_chunk13"] = _zero(weights, mesh, wire="int8", chunk=13,
                                    steps=2)["losses"]
        m = _mlp(weights)
        s = CompressedAllReduceTrainStep(m, _loss_fn, _opt("momentum", m),
                                         mesh=mesh, compress_dtype="bf16")
        out["allreduce_bf16"] = _run(s, *_data(), steps=3)
        z = _zero(weights, mesh, "adam", steps=5)
        out["adam5"] = {"losses": z["losses"], "params": z["params"]}
        z = _zero(weights, mesh, steps=4,
                  grad_clip=ClipGradByGlobalNorm(0.25))
        out["clip"] = z["losses"]
        torch.manual_seed(0)
        big = torch.nn.Sequential(Linear(256, 512, device="cpu"),
                                  torch.nn.ReLU(),
                                  Linear(512, 256, device="cpu"))
        zb = ShardedUpdateTrainStep(big, _loss_fn, Adam(learning_rate=0.01),
                                    mesh=mesh)
        out["big_opt_bytes"] = zb.opt_state_bytes_per_replica()
        out["wire_bytes"] = {w: z["step"].collective_wire_bytes(w)
                             for w in ("f32", "bf16", "f16", "int8",
                                       "int4")}
        zc = ShardedUpdateTrainStep(_mlp(weights), _loss_fn,
                                    Momentum(learning_rate=0.05),
                                    mesh=mesh, chunk=256)
        out["wire_bytes_256"] = {w: zc.collective_wire_bytes(w)
                                 for w in ("f32", "bf16", "int8", "int4")}
    return out


def _worker(rank, dp, weights, init, path):
    torch.set_num_threads(1)
    init_process_group("cpu", rank=rank, world_size=dp, init_method=init)
    try:
        torch.save(_readings(weights, make_mesh({"dp": dp})),
                   f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _reference_weights():
    """The reference MLP's initial weights (paddle.seed(0)), by name."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    paddle.seed(0)
    m = jnn.Sequential(jnn.Linear(7, 33), jnn.ReLU(), jnn.Linear(33, 1))
    return m, {n: np.asarray(p._data) for n, p in m.named_parameters()}


def _spawn(dp, tmp_path_factory):
    _, weights = _reference_weights()
    d = tmp_path_factory.mktemp(f"dp{dp}")
    mp.spawn(_worker, args=(dp, weights, f"file://{d}/store", str(d)),
             nprocs=dp, join=True)
    return weights, [torch.load(d / f"rank{r}.pt", weights_only=False)
                     for r in range(dp)]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


def _world(request, dp):
    return request.getfixturevalue(f"dp{dp}")


def _equal_params(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


# ---------------------------------------------------------------------------
# exact f32 parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_f32_zero_bitwise_replicated(request, dp, opt):
    weights, ranks = _world(request, dp)
    for got in ranks:
        z, r = got[f"{opt}_zero"], got[f"{opt}_replicated"]
        assert z["losses"] == r["losses"]
        _equal_params(z["params"], r["params"])
    # each rank holds its chunk of every moment: joined in rank order and
    # stripped of the padding, they are the replicated moments
    specs = build_shard_specs({n: torch.from_numpy(np.array(w))
                               for n, w in weights.items()}, dp, 8)
    rep = ranks[0][f"{opt}_replicated"]["states"]
    for n, slots in rep.items():
        for k, want in slots.items():
            shards = [got[f"{opt}_zero"]["states"][n][k] for got in ranks]
            if want.dim() == 0:
                assert all(torch.equal(s, want) for s in shards)
                continue
            joined = torch.cat(shards)
            assert joined.numel() == specs[n].padded
            assert torch.equal(joined[:specs[n].size], want.reshape(-1))
            assert not joined[specs[n].size:].any()


@pytest.mark.parametrize("dp", [2, 4])
def test_ring_f32_equals_unfused_legs(request, dp):
    _, ranks = _world(request, dp)
    for got in ranks:
        assert got["ring_f32"]["losses"] == got["momentum_zero"]["losses"]
        _equal_params(got["ring_f32"]["params"],
                      got["momentum_zero"]["params"])


def _ring_model(x, chunk, wire):
    """The quantized ring by its definition, on the reference's numpy codec
    (paddle_tpu/distributed/wire.py).  The partial of chunk c starts at rank
    c + 1 as that rank's block c, encoded, and visits ranks c + 2, ..., c:
    each decodes it, adds its own block c in f32 and re-encodes it, and
    rank c decodes the last.  The all-gather decodes each sum's one
    encoding.  Returns the (dp, shard) sums and the gathered vector."""
    from paddle_tpu.distributed.wire import dequantize_rows, quantize_rows
    n = x.shape[0]
    blocks = x.reshape(n, n, -1, chunk)        # [rank, chunk, rows, width]
    sums = []
    for c in range(n):
        q = quantize_rows(blocks[(c + 1) % n, c], wire)
        for h in range(2, n + 1):
            q = quantize_rows(dequantize_rows(q, wire)
                              + blocks[(c + h) % n, c], wire)
        sums.append(dequantize_rows(q, wire))
    gathered = [dequantize_rows(quantize_rows(p, wire), wire) for p in sums]
    return (np.stack(sums).reshape(n, -1),
            np.concatenate(gathered).reshape(-1))


def _jax_ring(x, dp, wire):
    """The reference's ring pair on the 8-device CPU mesh, as its
    test_ring_collectives.py runs it: the (dp, shard) reduce-scattered sums
    and every rank's gathered vector."""
    import jax
    from jax.sharding import PartitionSpec as P
    from paddle_tpu.parallel import make_mesh as jmake_mesh
    from paddle_tpu.parallel import ring as jring
    from paddle_tpu.parallel.mesh import shard_map_compat
    mesh = jmake_mesh({"dp": dp}, devices=jax.devices()[:dp])

    def body(xl):
        s = jring.ring_reduce_scatter(xl.reshape(-1), "dp", axis_size=dp,
                                      chunk=8, wire=wire)
        g = jring.ring_all_gather(s, "dp", axis_size=dp, chunk=8,
                                  wire=wire)
        return s, g[None]
    s, g = shard_map_compat(body, mesh=mesh, in_specs=(P("dp"),),
                            out_specs=(P("dp"), P("dp")))(x)
    return np.asarray(s).reshape(dp, -1), np.asarray(g)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("wire,qmax", [("int8", 127.0), ("int4", 7.0)])
def test_quantized_ring_primitives_match_reference(request, dp, wire, qmax):
    """The int8 / int4 ring_reduce_scatter and ring_all_gather on the gloo
    ranks: bitwise the ring by its definition on the reference's numpy
    codec, every rank's gathered vector the same bits, within the reference
    test_ring_collectives.py's envelope of the exact sum, and within 1e-5
    of the JAX ring (XLA's CPU backend fuses the decode's multiply and the
    add into one FMA, so a hop's sum can differ in its last bit: 9.5e-7 at
    most on this input)."""
    _, ranks = _world(request, dp)
    x = _ring_input(dp).numpy()
    sums, gathered = _ring_model(x, 8, wire)
    got_s = np.stack([got[f"ring_rs_ag_{wire}"][0].numpy() for got in ranks])
    np.testing.assert_array_equal(got_s, sums)
    for got in ranks:
        np.testing.assert_array_equal(got[f"ring_rs_ag_{wire}"][1].numpy(),
                                      gathered)
    bound = dp * (np.abs(x).sum(axis=0).max() / qmax) + 1e-6
    assert np.abs(got_s.reshape(-1) - x.sum(axis=0)).max() <= bound
    s_j, g_j = _jax_ring(x, dp, wire)
    np.testing.assert_allclose(got_s, s_j, rtol=0, atol=1e-5)
    for r in range(dp):
        np.testing.assert_allclose(gathered, g_j[r], rtol=0, atol=1e-5)


def test_f32_zero_matches_jax_sharded_update(dp2):
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel import make_mesh as jmake_mesh
    from paddle_tpu.parallel import set_mesh as jset_mesh
    from paddle_tpu.parallel.zero import ShardedUpdateTrainStep as JZero
    import jax
    weights, ranks = dp2
    x, y = _data()
    for opt, steps, key in (("adam", 5, "adam5"),
                            ("momentum", STEPS, "momentum_zero")):
        m, _ = _reference_weights()
        mesh = jmake_mesh({"dp": 2}, devices=jax.devices()[:2])
        jset_mesh(mesh)
        o = (jopt.Adam(learning_rate=0.05, parameters=m.parameters())
             if opt == "adam" else
             jopt.Momentum(learning_rate=0.05, momentum=0.9,
                           parameters=m.parameters()))
        z = JZero(m, _loss_fn, o, mesh=mesh, wire_dtype="f32", chunk=8)
        T = paddle.to_tensor
        want = [float(z(T(x), T(y))) for _ in range(steps)]
        got = ranks[0][key]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4,
                                   atol=1e-5)
        for n, p in m.named_parameters():
            np.testing.assert_allclose(got["params"][n].numpy(),
                                       np.asarray(p._data), rtol=1e-4,
                                       atol=1e-5, err_msg=n)


def test_close_to_plain_full_batch_trainstep(dp2):
    weights, ranks = dp2
    m = _mlp(weights)
    t = TrainStep(m, _loss_fn, _opt("adam", m))
    x, y = _data()
    lt = _run(t, torch.from_numpy(x), torch.from_numpy(y), 5)
    np.testing.assert_allclose(ranks[0]["adam5"]["losses"], lt, rtol=1e-4,
                               atol=1e-5)
    for n, p in m.named_parameters():
        np.testing.assert_allclose(ranks[0]["adam5"]["params"][n].numpy(),
                                   p.detach().numpy(), rtol=1e-4, atol=1e-5)


def test_global_norm_clip_matches_replicated(dp2):
    weights, ranks = dp2
    m = _mlp(weights)
    t = TrainStep(m, _loss_fn, _opt("momentum", m,
                                    grad_clip=ClipGradByGlobalNorm(0.25)))
    lt = _run(t, *(torch.from_numpy(a) for a in _data()), steps=4)
    np.testing.assert_allclose(ranks[0]["clip"], lt, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# quantized wires
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_bounded_drift_and_still_trains(dp2, wire):
    _, ranks = dp2
    for got in ranks:
        lq, lf = got[f"{wire}_ring0"]["losses"], got["momentum_zero"][
            "losses"]
        assert lq[-1] < lq[0] * 0.5
        for a, b in zip(lq, lf):
            assert abs(a - b) <= DRIFT[wire] * max(1.0, abs(b))


@pytest.mark.parametrize("wire,tol", [("bf16", 2e-2), ("int8", 8e-2),
                                      ("int4", 4e-1)])
def test_quantized_ring_bounded_drift(dp2, wire, tol):
    """The ring's losses track the f32 ring's (itself bitwise the unfused
    f32 run) within the reference's bounds
    (test_ring_collectives.py:277-293), and the ring still trains."""
    _, ranks = dp2
    for got in ranks:
        lq, lf = got[f"{wire}_ring1"]["losses"], got["ring_f32"]["losses"]
        assert lq[-1] < lq[0] * 0.5
        for a, b in zip(lq, lf):
            assert abs(a - b) <= tol * max(1.0, abs(b))


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("ring", [0, 1])
def test_quantized_replicas_bitwise_equal_and_train(request, dp, wire,
                                                    ring):
    _, ranks = _world(request, dp)
    key = f"{wire}_ring{ring}"
    for got in ranks[1:]:
        assert got[key]["losses"] == ranks[0][key]["losses"]
        _equal_params(got[key]["params"], ranks[0][key]["params"])
    lq = ranks[0][key]["losses"]
    assert lq[-1] < lq[0] * 0.5


def test_int8_needs_no_special_chunk_and_bf16_allreduce_runs(dp2):
    _, ranks = dp2
    losses = ranks[0]["int8_chunk13"]
    assert losses[1] < losses[0]
    ar = ranks[0]["allreduce_bf16"]
    assert all(np.isfinite(ar)) and ar[-1] < ar[0]


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def test_wire_bytes_match_reference(dp2):
    import jax
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parallel import make_mesh as jmake_mesh
    from paddle_tpu.parallel.zero import ShardedUpdateTrainStep as JZero
    _, ranks = dp2
    mesh = jmake_mesh({"dp": 2}, devices=jax.devices()[:2])
    for chunk, key in ((8, "wire_bytes"), (256, "wire_bytes_256")):
        m, _ = _reference_weights()
        z = JZero(m, _loss_fn, jopt.Momentum(learning_rate=0.05,
                                             parameters=m.parameters()),
                  mesh=mesh, chunk=chunk)
        for w, got in ranks[0][key].items():
            assert got == z.collective_wire_bytes(w), (chunk, w)
    f32, bf16 = ranks[0]["wire_bytes_256"]["f32"], ranks[0][
        "wire_bytes_256"]["bf16"]
    for leg in ("reduce_scatter", "all_gather"):
        assert bf16[leg] / f32[leg] == 0.5
        assert ranks[0]["wire_bytes_256"]["int8"][leg] / f32[leg] <= 0.26


def test_opt_state_bytes_sharded_below_replicated(dp2):
    _, ranks = dp2
    big = torch.nn.Sequential(Linear(256, 512, device="cpu"),
                              torch.nn.ReLU(), Linear(512, 256,
                                                      device="cpu"))
    opt = Adam(learning_rate=0.01)
    states = opt.functional_init_states(dict(big.named_parameters()))
    replicated = sum(t.numel() * t.element_size()
                     for st in states.values() for t in st.values())
    for got in ranks:
        assert got["big_opt_bytes"] <= 0.6 * replicated


# ---------------------------------------------------------------------------
# in-process: the simulated ranks, the rules
# ---------------------------------------------------------------------------

def test_loopback_ranks_give_the_gloo_bits(dp2):
    weights, ranks = dp2
    sim = LoopbackWorld(2).run(lambda r, mesh: _zero(weights, mesh, "adam"))
    for got, s in zip(ranks, sim):
        assert s["losses"] == got["adam_zero"]["losses"]
        _equal_params(s["params"], got["adam_zero"]["params"])
    sim = LoopbackWorld(2).run(
        lambda r, mesh: _zero(weights, mesh, wire="int4", ring=True))
    for got, s in zip(ranks, sim):
        assert s["losses"] == got["int4_ring1"]["losses"]
        _equal_params(s["params"], got["int4_ring1"]["params"])


def test_sharded_step_refuses_what_it_cannot_shard():
    weights = {"0.weight": np.ones((7, 33), np.float32),
               "0.bias": np.zeros(33, np.float32),
               "2.weight": np.ones((33, 1), np.float32),
               "2.bias": np.zeros(1, np.float32)}

    def check(rank, mesh):
        m = _mlp(weights)

        class LarsMomentum(Momentum):
            pass

        with pytest.raises(TypeError, match="norm-per-parameter"):
            ShardedUpdateTrainStep(m, _loss_fn, LarsMomentum(), mesh=mesh)
        with pytest.raises(NotImplementedError, match="functional_clip"):
            ShardedUpdateTrainStep(m, _loss_fn, SGD(
                grad_clip=ClipGradByNorm(1.0)), mesh=mesh)
        with pytest.raises(NotImplementedError, match="grad_clip"):
            CompressedAllReduceTrainStep(m, _loss_fn, SGD(
                grad_clip=ClipGradByGlobalNorm(1.0)), mesh=mesh)
        with pytest.raises(ValueError, match="wire"):
            CompressedAllReduceTrainStep(m, _loss_fn, SGD(), mesh=mesh,
                                         compress_dtype="int8")
        with pytest.raises(ValueError, match="pure data-parallel"):
            ShardedUpdateTrainStep(m, _loss_fn, SGD(), mesh=Mesh(
                {"dp": 1, "mp": 2}, mesh.group))
        set_flags({"zero_wire_dtype": "int4", "zero_ring_collectives": True})
        try:
            s = ShardedUpdateTrainStep(m, _loss_fn, SGD(), mesh=mesh)
        finally:
            set_flags({"zero_wire_dtype": "bf16",
                       "zero_ring_collectives": False})
        assert (s.wire, s.ring) == ("int4", True)
        s = ShardedUpdateTrainStep(m, _loss_fn, SGD(), mesh=mesh)
        assert (s.wire, s.ring) == ("bf16", False)

    LoopbackWorld(2).run(check)
    # a mesh may name mp (fleet's topology reads it); what it lacks here
    # is a process group to lay out
    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh({"dp": 2, "mp": 2})
    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh({"dp": 1})


def test_sgd_and_nesterov_momentum_match_reference():
    import jax.numpy as jnp
    from paddle_tpu import optimizer as jopt
    rng = np.random.default_rng(4)
    p, g = (rng.standard_normal(10).astype(np.float32) for _ in range(2))
    for topt, jo in ((SGD(0.1), jopt.SGD(0.1)),
                     (Momentum(0.1, 0.9, use_nesterov=True),
                      jopt.Momentum(0.1, 0.9, use_nesterov=True))):
        ts, js = topt.init_state(torch.from_numpy(p)), jo.init_state(
            jnp.asarray(p))
        tp, jp = torch.from_numpy(p), jnp.asarray(p)
        for _ in range(3):
            tp, ts = topt.update(tp, torch.from_numpy(g), ts, 0.1)
            jp, js = jo.update(jp, jnp.asarray(g), js, 0.1)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


def test_loopback_collectives_under_thread_switching():
    """More simulated ranks than cores, a thread switch every microsecond:
    every primitive still hands each rank exactly its peers' tensors."""
    n = 12
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def fn(rank, mesh):
        g = mesh.group
        for it in range(10):
            x = torch.stack([torch.tensor([rank * 100.0 + it, float(j)])
                             for j in range(n)])
            a2a = g.all_to_all(x)            # [j] is rank j's x[rank]
            assert torch.equal(a2a[:, 0], torch.arange(n) * 100.0 + it)
            assert bool((a2a[:, 1] == rank).all())
            ag = g.all_gather(torch.tensor([rank, it]))
            assert ag.tolist() == [[j, it] for j in range(n)]
            (got,) = g.ring_shift([torch.tensor([rank, it])])
            assert got.tolist() == [(rank - 1) % n, it]
        return rank

    try:
        assert LoopbackWorld(n, timeout=60).run(fn) == list(range(n))
    finally:
        sys.setswitchinterval(old)


def test_loopback_rank_error_reaches_the_caller():
    def fn(rank, mesh):
        if rank == 1:
            raise ValueError("rank 1 fails")
        mesh.group.all_gather(torch.zeros(1))   # the others wait, then break

    with pytest.raises(ValueError, match="rank 1 fails"):
        LoopbackWorld(3, timeout=60).run(fn)
