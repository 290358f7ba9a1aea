"""The port's collective API (paddle_tpu_torch/distributed/collective.py),
its mesh (parallel/mesh.py: axis groups, the topology) and the process
environment (distributed/parallel.py, spawn.py), held to the reference.

Each rank of the port calls a collective on its own tensor, as each shard
of the reference's ``shard_map`` does; the references run on 2- and
4-device sub-meshes of the 8 virtual CPU devices, the port on as many
``LoopbackWorld`` ranks, from the same numpy inputs.  Comparisons:
bitwise where the arithmetic is the same (MAX, MIN, gathers, broadcasts,
shifts, sums of two ranks), within 1e-6 of f32 otherwise (sums of four,
the log-space product), and the product's zeros and signs exact.  One
spawn of two gloo processes runs the same readings over real process
groups: bitwise the loopback ranks', and so are two steps of
ShardedTrainStep at stages 0 and 2 on a BatchNorm MLP there."""
import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.nn import BatchNorm1D, Linear
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.parallel import (HybridTopology, LoopbackWorld,
                                       ShardedTrainStep, auto_mesh,
                                       init_process_group, make_mesh,
                                       mesh_axis_size, set_mesh, shard_spec)

OPS = ("SUM", "MAX", "MIN", "AVG", "PROD")


def _inputs(n):
    """Rank r's rows: x (3, 5) f32 with negatives, a zero in column 4 on
    rank 1, and y (n * 2, 3) for the scatters."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3, 5)).astype(np.float32)
    x[1, :, 4] = 0.0
    y = rng.standard_normal((n, n * 2, 3)).astype(np.float32)
    return x, y


def _port_readings(rank, n, x, y):
    """Every collective of the comparison on this rank's tensors."""
    xt, yt = torch.from_numpy(x[rank]), torch.from_numpy(y[rank])
    out = {op: dist.all_reduce(xt.clone(), op=getattr(dist.ReduceOp, op))
           for op in OPS}
    out["reduce"] = dist.reduce(xt.clone(), dst=0)
    out["broadcast"] = dist.broadcast(xt.clone(), src=n - 1)
    gathered = []
    out["all_gather"] = dist.all_gather(gathered, xt)
    assert len(gathered) == n
    out["reduce_scatter"] = dist.reduce_scatter(None, yt)
    out["reduce_scatter_list"] = dist.reduce_scatter(
        torch.zeros(2, 3), list(yt.reshape(n, 2, 3)))
    out["alltoall"] = dist.alltoall(yt.reshape(n, 2, 3))
    out["scatter"] = dist.scatter(torch.zeros(2, 3),
                                  list(yt.reshape(n, 2, 3)), src=1)
    for off in (1, -1):
        for wrap in (False, True):
            out[f"shift{off}{wrap}"] = dist.p2p_shift(xt, off, wrap=wrap)
    return {k: v.numpy().copy() for k, v in out.items()}


def _step_readings(mesh):
    """Two SGD steps of ShardedTrainStep at stages 0 and 2 on this
    rank's replica of a BatchNorm MLP (its weights drawn from one numpy
    seed on every rank): its parameters and buffers after them, by
    stage."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, size=(8,)))
    out = {}
    for stage in (0, 2):
        m = torch.nn.Sequential(Linear(16, 32, device="cpu"),
                                BatchNorm1D(32, device="cpu"),
                                torch.nn.Tanh(), Linear(32, 4, device="cpu"))
        w = np.random.default_rng(8)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(w.standard_normal(
                    tuple(p.shape)).astype(np.float32)) * 0.3)
        step = ShardedTrainStep(
            m, lambda m, x, y: torch.nn.functional.cross_entropy(m(x), y),
            SGD(learning_rate=0.1), mesh=mesh, sharding_stage=stage)
        for _ in range(2):
            step(x, y)
        out.update({f"stage{stage}.{k}": v.detach().numpy().copy()
                    for k, v in m.state_dict().items()})
    return out


def _jax_readings(n, x, y):
    """The same collectives inside the reference's shard_map over n of
    the 8 CPU devices; every output stacked by rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import paddle_tpu.distributed as jdist
    from paddle_tpu.parallel import get_mesh as jget, make_mesh as jmake
    from paddle_tpu.parallel import set_mesh as jset
    from paddle_tpu.parallel.mesh import shard_map_compat

    def body(xl, yl):
        xl, yl = xl[0], yl[0]
        out = {op: jdist.all_reduce(xl, op=getattr(jdist.ReduceOp, op))
               for op in OPS}
        out["reduce"] = jdist.reduce(xl, dst=0)
        out["broadcast"] = jdist.broadcast(xl, src=n - 1)
        out["all_gather"] = jdist.all_gather(None, xl)
        out["reduce_scatter"] = jdist.reduce_scatter(None, yl)
        out["reduce_scatter_list"] = jdist.reduce_scatter(
            None, list(yl.reshape(n, 2, 3)))
        out["alltoall"] = jdist.alltoall(yl.reshape(n, 2, 3))
        out["scatter"] = jdist.scatter(jnp.zeros((2, 3)),
                                       list(yl.reshape(n, 2, 3)), src=1)
        for off in (1, -1):
            for wrap in (False, True):
                out[f"shift{off}{wrap}"] = jdist.p2p_shift(xl, off,
                                                           wrap=wrap)
        return {k: v[None] for k, v in out.items()}

    prev = jget()
    mesh = jset(jmake({"dp": n}, devices=jax.devices()[:n]))
    try:
        got = jax.jit(shard_map_compat(body, mesh, (P("dp"), P("dp")),
                                       P("dp")))(jnp.asarray(x),
                                                 jnp.asarray(y))
    finally:
        jset(prev)
    return {k: np.asarray(v) for k, v in got.items()}


@pytest.fixture(scope="module")
def readings():
    out = {}
    for n in (2, 4):
        x, y = _inputs(n)
        port = LoopbackWorld(n).run(
            lambda r, mesh: {**_port_readings(r, n, x, y),
                             **(_step_readings(mesh) if n == 2 else {})})
        out[n] = (port, _jax_readings(n, x, y))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("what", ["MAX", "MIN", "reduce", "broadcast",
                                  "all_gather", "reduce_scatter",
                                  "reduce_scatter_list", "alltoall",
                                  "scatter", "shift1False", "shift1True",
                                  "shift-1False", "shift-1True", "SUM",
                                  "AVG"])
def test_collective_matches_shard_map(readings, n, what):
    """Each rank's result is the reference shard's: bitwise, save the sums
    and means of four ranks, whose order of addition may differ (1e-6)."""
    port, ref = readings[n]
    for r in range(n):
        if n == 4 and what in ("SUM", "AVG", "reduce", "reduce_scatter",
                               "reduce_scatter_list"):
            np.testing.assert_allclose(port[r][what], ref[what][r],
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(port[r][what], ref[what][r])


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduce_prod_is_the_log_space_product(readings, n):
    """PROD is the reference's in-region exp(sum log|x|): within 1e-6 of
    it, its zeros and signs exact, and within f32 of the plain product."""
    port, ref = readings[n]
    x, _ = _inputs(n)
    for r in range(n):
        got = port[r]["PROD"]
        np.testing.assert_allclose(got, ref["PROD"][r], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got == 0, ref["PROD"][r] == 0)
        np.testing.assert_array_equal(np.sign(got), np.sign(ref["PROD"][r]))
        np.testing.assert_allclose(got, x.prod(0), rtol=1e-5, atol=0)
    assert (port[0]["PROD"][:, 4] == 0).all()


def test_axis_groups_match_the_reference_on_a_dp_x_mp_mesh():
    """new_group(axis=) on a dp=2 x mp=2 mesh: reductions and a broadcast
    from group rank 1 along each axis, and along both; the group sizes and
    this rank's coordinates from the topology."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import paddle_tpu.distributed as jdist
    from paddle_tpu.parallel import get_mesh as jget, make_mesh as jmake
    from paddle_tpu.parallel import set_mesh as jset
    from paddle_tpu.parallel.mesh import shard_map_compat
    x = np.random.default_rng(7).standard_normal((4, 6)).astype(np.float32)

    def jbody(xl):
        xl = xl[0]
        out = {}
        for axis in ("dp", "mp", ("dp", "mp")):
            g = jdist.new_group(axis=axis)
            out[f"sum_{axis}"] = jdist.all_reduce(xl, group=g)
            out[f"max_{axis}"] = jdist.all_reduce(xl, op=jdist.ReduceOp.MAX,
                                                  group=g)
            out[f"bcast_{axis}"] = jdist.broadcast(xl, src=1, group=g)
        return {k: v[None] for k, v in out.items()}

    prev = jget()
    mesh = jset(jmake({"dp": 2, "mp": 2}, devices=jax.devices()[:4]))
    try:
        ref = jax.jit(shard_map_compat(jbody, mesh, (P(("dp", "mp")),),
                                       P(("dp", "mp"))))(jnp.asarray(x))
        sizes = {a: jdist.new_group(axis=a).nranks for a in ("dp", "mp")}
    finally:
        jset(prev)

    def fn(rank, m):
        xt = torch.from_numpy(x[rank])
        out = {}
        for axis in ("dp", "mp", ("dp", "mp")):
            g = dist.new_group(axis=axis)
            out[f"sum_{axis}"] = dist.all_reduce(xt.clone(), group=g)
            out[f"max_{axis}"] = dist.all_reduce(
                xt.clone(), op=dist.ReduceOp.MAX, group=g)
            out[f"bcast_{axis}"] = dist.broadcast(xt.clone(), src=1, group=g)
        topo = HybridTopology(m)
        return ({k: v.numpy() for k, v in out.items()},
                {a: dist.new_group(axis=a).nranks for a in ("dp", "mp")},
                (topo.axis_rank(rank, "dp"), topo.axis_rank(rank, "mp")))

    got = LoopbackWorld(4).run(fn, axes={"mp": 2, "dp": 2})
    for r, (vals, nr, coord) in enumerate(got):
        assert nr == sizes
        assert coord == (r // 2, r % 2)
        for k, v in vals.items():
            np.testing.assert_array_equal(v, np.asarray(ref[k])[r], err_msg=k)


def test_new_group_of_ranks_send_recv_and_topology():
    """new_group(ranks=): its size, group ranks (-1 outside), a broadcast
    from a world rank mapped into the group; send / recv between ranks; the
    topology's coordinates round-trip as the reference's."""
    import jax
    from paddle_tpu.parallel import HybridTopology as JTopo
    from paddle_tpu.parallel import make_mesh as jmake
    jtopo = JTopo(jmake({"pp": 2, "dp": 2, "mp": 2},
                        devices=jax.devices()[:8]))

    def fn(rank, m):
        g = dist.new_group(ranks=[1, 3])
        got = {"nranks": g.nranks, "rank": g.rank,
               "grank": g.get_group_rank(3)}
        if rank in (1, 3):
            got["bcast"] = dist.broadcast(torch.tensor([float(rank)]),
                                          src=3, group=g).item()
        if rank == 0:
            dist.send(torch.tensor([7.0, 8.0]), dst=2)
        if rank == 2:
            got["recv"] = dist.recv(torch.zeros(2), src=0).tolist()
        dist.barrier()
        topo = HybridTopology(m)
        got["topo"] = [(topo.coordinate(q), topo.group_ranks(q, "mp"),
                        topo.group_ranks(q, "dp")) for q in range(8)]
        return got

    res = LoopbackWorld(8).run(fn, axes={"pp": 2, "dp": 2, "mp": 2})
    for r, got in enumerate(res):
        assert got["nranks"] == 2 and got["grank"] == 1
        assert got["rank"] == {1: 0, 3: 1}.get(r, -1)
        if r in (1, 3):
            assert got["bcast"] == 3.0
        want = [(jtopo.coordinate(q), jtopo.group_ranks(q, "mp"),
                 jtopo.group_ranks(q, "dp")) for q in range(8)]
        assert got["topo"] == want
    assert res[2]["recv"] == [7.0, 8.0]


def test_mesh_helpers_and_the_lone_process():
    """auto_mesh / mesh_axis_size / shard_spec as the reference's; in a
    lone process every collective is the identity of one rank, and split
    (item 3b, ported) builds the plain layer of one rank: the layer, or
    its output for a tensor; an unknown operation raises."""
    def fn(rank, m):
        mesh = set_mesh(auto_mesh(sharding=2))
        return (dict(mesh.shape), mesh_axis_size("sharding"),
                mesh_axis_size("mp"), shard_spec("dp", ("sharding", "mp"),
                                                 None, "mp"))
    got = LoopbackWorld(4).run(fn)
    assert got[0] == ({"dp": 2, "sharding": 2}, 2, 1,
                      ("dp", ("sharding",)))
    t = torch.tensor([1.0, -2.0])
    for op in OPS:
        assert torch.equal(dist.all_reduce(t.clone(),
                                           op=getattr(dist.ReduceOp, op)), t)
    out = []
    dist.all_gather(out, t)
    assert len(out) == 1 and torch.equal(out[0], t)
    # all_gather(None, t) is t's shape X and scatter without a list leaves
    # t as it is, as the reference's lone process returns them
    import paddle_tpu as jpaddle
    import paddle_tpu.distributed as jdist
    jt = jpaddle.to_tensor(t.numpy())
    assert tuple(np.asarray(jdist.all_gather(None, jt)).shape) == (2,)
    assert dist.all_gather(None, t).shape == t.shape
    assert torch.equal(dist.all_gather(None, t), t)
    assert np.array_equal(np.asarray(jdist.scatter(jt).numpy()), t.numpy())
    s = t.clone()
    assert torch.equal(dist.scatter(s), t) and torch.equal(s, t)
    # inside a region of n ranks all_gather stays (n, *X)
    assert LoopbackWorld(2).run(
        lambda r, m: tuple(dist.all_gather(None, t).shape)) == [(2, 2)] * 2
    assert dist.get_rank() == 0 and dist.get_world_size() == 1
    assert dist.is_initialized()
    dist.barrier()
    assert torch.equal(dist.wait(t), t)
    from paddle_tpu_torch import device as tdevice
    was = tdevice.get_device()
    tdevice.set_device("cpu")
    try:
        col = dist.split(None, (2, 3), "linear", axis=1)
        assert type(col).__name__ == "ColumnParallelLinear"
        assert col.weight.shape == (2, 3)
        assert dist.split(t, (2, 3), "linear").shape == (3,)
        assert dist.split(torch.tensor([1, 0]), (4, 3),
                          "embedding").shape == (2, 3)
        with pytest.raises(ValueError, match="unsupported split"):
            dist.split(t, (2, 2), "conv")
    finally:
        tdevice._default = was


def test_parallel_env_and_spawn_read_the_protocol(monkeypatch):
    """ParallelEnv reads the PADDLE_* env as the reference does; spawn runs
    func once here after init_parallel_env (a one-rank gloo group) and
    warns for nprocs > 1."""
    import paddle_tpu.distributed as jdist
    env = {"PADDLE_TRAINER_ID": "2", "PADDLE_TRAINERS_NUM": "4",
           "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6070,10.0.0.2:6070,"
           "10.0.0.3:6070,10.0.0.4:6070",
           "PADDLE_CURRENT_ENDPOINT": "10.0.0.3:6070",
           "FLAGS_selected_gpus": "3"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    a, b = dist.ParallelEnv(), jdist.ParallelEnv()
    for k in ("rank", "world_size", "trainer_endpoints", "current_endpoint",
              "device_id", "local_rank", "nranks", "dev_id"):
        assert getattr(a, k) == getattr(b, k), k
    for k in env:
        monkeypatch.delenv(k)
    with pytest.warns(UserWarning, match="once"):
        ctx = dist.spawn(lambda v: (v, dist.get_world_size()), args=(5,),
                         nprocs=2, device="cpu")
    try:
        assert ctx.join() and ctx.result == (5, 1)
    finally:
        tdist.destroy_process_group()
        set_mesh(None)


def _gloo_worker(rank, n, path, init):
    torch.set_num_threads(1)
    init_process_group("cpu", rank=rank, world_size=n, init_method=init)
    try:
        x, y = _inputs(n)
        out = _port_readings(rank, n, x, y)
        out.update(_step_readings(make_mesh({"dp": n})))
        model = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(model.weight, float(rank))
        dist.DataParallel(model)
        out["dp_weight"] = model.weight.detach().numpy().copy()
        g = dist.new_group(ranks=[1])
        out["member"] = np.array(g.rank)
        torch.save(out, f"{path}/rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


def test_gloo_processes_give_the_loopback_bits(readings, tmp_path):
    """Two gloo processes: every reading bitwise the loopback ranks', the
    sharded steps' included, and DataParallel broadcasts rank 0's
    parameters at construction."""
    mp.spawn(_gloo_worker, args=(2, str(tmp_path),
                                 f"file://{tmp_path}/store"),
             nprocs=2, join=True)
    port, _ = readings[2]
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        for k, v in port[r].items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        for k in [k for k in got if k.startswith("stage0.")]:
            np.testing.assert_array_equal(
                got[k], got["stage2." + k[len("stage0."):]], err_msg=k)
        assert (got["dp_weight"] == 0.0).all()
        assert int(got["member"]) == (0 if r == 1 else -1)
