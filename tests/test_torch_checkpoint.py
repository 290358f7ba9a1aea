"""The port's state plane (paddle_tpu_torch/distributed/{checkpoint,durable}.py,
framework/auto_checkpoint.py, fleet/utils/fs.py, the ZeRO step's
checkpoint interop) against the reference's on the CPU.

A checkpoint directory is the reference's layout: the same file names,
metadata and bytes for the same state (GPT ``gpt_tiny``'s TrainStep state,
a bf16 leaf), and each package loads the other's.  State carried across
trains on: an MLP (Linear 7-33-1, Adam) restored from the other package's
directory takes the next step within 1e-5 of the saving package's own.
ZeRO at dp = 2 (``LoopbackWorld`` ranks, f32 wire) writes each rank's
moment chunks under the reference's index windows: the metadata is the
reference's ZeRO step's but for the stamps, values within 1e-5, and the
reference's ``load_sharded`` reads it.  Generations: retention, the
corrupt-generation walk, async saves bitwise the sync save while training
goes on, the SIGTERM emergency save, ``TrainEpochRange`` resuming after a
crash, ``LocalFS``.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed import durable as jdur
from paddle_tpu.distributed.fleet.utils import fs as jfs
from paddle_tpu.framework import auto_checkpoint as jacp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
from paddle_tpu.parallel.zero import ShardedUpdateTrainStep as JZero
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed import durable as tdur
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.utils import fs as tfs
from paddle_tpu_torch.framework import auto_checkpoint as tacp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPT, gpt_loss, gpt_tiny, \
    load_named_params
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import LoopbackWorld
from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep

from torch_planes_common import PORT, clean_planes

TOL = 1e-5
TINY = dict(num_layers=2, hidden_size=128, num_heads=2, max_seq_len=128,
            remat=False)


@pytest.fixture(autouse=True)
def _one_device_mesh():
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    yield
    set_mesh(prev)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".npy")}


def _meta(d):
    with open(os.path.join(d, "metadata.json")) as f:
        return json.load(f)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 7)).astype(np.float32)
    return x, (x @ rng.standard_normal((7, 1))).astype(np.float32)


def _loss(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _ref_mlp():
    paddle.seed(0)
    m = jnn.Sequential(jnn.Linear(7, 33), jnn.ReLU(), jnn.Linear(33, 1))
    return m, {n: np.asarray(p._data) for n, p in m.named_parameters()}


def _mlp(weights):
    m = torch.nn.Sequential(Linear(7, 33, device="cpu"), torch.nn.ReLU(),
                            Linear(33, 1, device="cpu"))
    return load_named_params(m, weights)


def _params(model, ref=False):
    if ref:
        return {n: np.asarray(p._data) for n, p in model.named_parameters()}
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _close(a, b, tol=TOL):
    assert a.keys() == b.keys()
    for n in a:
        np.testing.assert_allclose(a[n], b[n], rtol=tol, atol=tol,
                                   err_msg=n)


def test_gpt_state_is_the_reference_layout(tmp_path):
    """gpt_tiny's TrainStep state (its initial weights, AdamW's fresh
    moments in the order the reference's jitted step keeps them, global
    step 5): the reference's directory loads into the
    port's step, and the port's save of it — and of a fresh port step
    holding the same weights — is the reference's, file for file and
    byte for byte, metadata included."""
    paddle.seed(0)
    jm = jgpt.GPT(jgpt.gpt_tiny(**TINY))
    init = {n: np.array(jm._parameters[n]._data) for n in jgpt._PARAM_ORDER}
    opt = jopt.AdamW(learning_rate=1e-4, parameters=jm.parameters())
    jstep = JTrainStep(jm, jgpt.gpt_loss, opt)
    # as a jitted step returns them: dicts rebuilt in sorted key order
    jstep._opt_states = jax.tree_util.tree_map(
        jnp.asarray, opt.functional_init_states(
            {n: p._data for n, p in jm.named_parameters()}))
    jck.save_train_state(jstep, str(tmp_path / "ref"), global_step=5)

    step = TrainStep(GPT(gpt_tiny(**TINY), device="cpu"), gpt_loss,
                     _adamw())
    tck.load_train_state(step, str(tmp_path / "ref"))
    assert step.optimizer._global_step == 5
    for n, p in step.model.named_parameters():
        assert np.array_equal(p.detach().numpy(), init[n]), n
    tck.save_train_state(step, str(tmp_path / "port"), global_step=5)
    fresh = TrainStep(GPT(gpt_tiny(**TINY), device="cpu").load_jax_params(
        init), gpt_loss, _adamw())
    fresh._opt_states = fresh.optimizer.functional_init_states(
        {n: p.detach() for n, p in fresh.model.named_parameters()})
    tck.save_train_state(fresh, str(tmp_path / "fresh"), global_step=5)
    want = _files(tmp_path / "ref")
    for d in ("port", "fresh"):
        assert _files(tmp_path / d) == want
        assert _meta(tmp_path / d) == _meta(tmp_path / "ref")


def _adamw():
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=1e-4)


@pytest.fixture(scope="module")
def mlp_runs(tmp_path_factory):
    """Two Adam steps of the MLP in each package from the reference's
    initial weights, each saved, and each package's third step."""
    d = tmp_path_factory.mktemp("mlp")
    x, y = _data()
    x2, y2 = _data(1)
    jm, init = _ref_mlp()
    js = JTrainStep(jm, _loss, jopt.Adam(learning_rate=0.05,
                                         parameters=jm.parameters()))
    T = paddle.to_tensor
    for _ in range(2):
        js(T(x), T(y))
    jck.save_train_state(js, str(d / "ref"), commit=True)
    js(T(x2), T(y2))
    ts = TrainStep(_mlp(init), _loss, Adam(learning_rate=0.05))
    for _ in range(2):
        ts(torch.from_numpy(x), torch.from_numpy(y))
    tck.save_train_state(ts, str(d / "port"), commit=True)
    ts(torch.from_numpy(x2), torch.from_numpy(y2))
    return {"dir": d, "init": init, "ref3": _params(jm, ref=True),
            "port3": _params(ts.model), "x2": x2, "y2": y2}


def test_port_resumes_from_the_reference(mlp_runs):
    """The reference's directory after two steps into a fresh port
    TrainStep (verified by the port, committed): its third step lands
    within 1e-5 of the reference's third step."""
    d = str(mlp_runs["dir"] / "ref")
    assert tck.is_committed(d) and tck.verify_checkpoint(d) == []
    ts = TrainStep(_mlp(mlp_runs["init"]), _loss, Adam(learning_rate=0.05))
    tck.load_train_state(ts, d)
    assert ts.optimizer._global_step == 2
    ts(torch.from_numpy(mlp_runs["x2"]), torch.from_numpy(mlp_runs["y2"]))
    _close(_params(ts.model), mlp_runs["ref3"])


def test_reference_resumes_from_the_port(mlp_runs):
    """The port's directory after two steps into a fresh reference
    TrainStep (verified by the reference): its third step lands within
    1e-5 of the port's third step."""
    d = str(mlp_runs["dir"] / "port")
    assert jck.is_committed(d) and jck.verify_checkpoint(d) == []
    jm, _ = _ref_mlp()
    js = JTrainStep(jm, _loss, jopt.Adam(learning_rate=0.05,
                                         parameters=jm.parameters()))
    jck.load_train_state(js, d)
    assert js.optimizer._global_step == 2
    T = paddle.to_tensor
    js(T(mlp_runs["x2"]), T(mlp_runs["y2"]))
    _close(_params(jm, ref=True), mlp_runs["port3"])


def test_bf16_leaves_both_ways(tmp_path):
    """A bf16 leaf: the port writes the reference's bytes ('<V2' words,
    "bfloat16" in the metadata) without ml_dtypes; each package's
    directory loads bitwise into the port; the reference verifies the
    port's."""
    v = np.random.default_rng(2).standard_normal((5, 6)).astype(np.float32)
    tb = torch.from_numpy(v).to(torch.bfloat16)
    tck.save_sharded({"w": tb, "s": torch.tensor(3.5, dtype=torch.bfloat16),
                      "n": np.int64(7)}, str(tmp_path / "port"), step=1)
    jck.save_sharded({"w": jnp.asarray(v).astype(jnp.bfloat16),
                      "s": jnp.asarray(3.5, jnp.bfloat16),
                      "n": np.int64(7)}, str(tmp_path / "ref"), step=1)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert _meta(tmp_path / "port") == _meta(tmp_path / "ref")
    assert _meta(tmp_path / "port")["leaves"][0]["dtype"] == "bfloat16"
    assert jck.verify_checkpoint(str(tmp_path / "port")) == []
    for d in ("port", "ref"):
        got = tck.load_sharded(str(tmp_path / d))
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), tb.view(torch.int16))
        assert float(got["s"]) == 3.5 and int(got["n"]) == 7


def test_zero_dp2_is_the_reference_layout(tmp_path):
    """ZeRO at dp = 2: each port rank writes its moment chunks under the
    reference's windows.  The metadata is the reference's ZeRO step's
    (same steps, weights, batch) but for the crc stamps; the chunks agree
    within 1e-5; the reference's load_sharded reads the port's directory,
    a replicated port TrainStep and a port ZeRO step at dp = 1 take the
    reference's directory and step on, within 1e-5 of each other."""
    x, y = _data()
    jm, init = _ref_mlp()
    mesh = make_mesh({"dp": 2}, devices=jax.devices()[:2])
    set_mesh(mesh)
    jz = JZero(jm, _loss, jopt.Adam(learning_rate=0.05,
                                    parameters=jm.parameters()),
               mesh=mesh, wire_dtype="f32", chunk=8)
    T = paddle.to_tensor
    jz(T(x), T(y))
    jck.save_train_state(jz, str(tmp_path / "ref"), commit=True)
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))

    def fn(rank, m):
        step = ShardedUpdateTrainStep(_mlp(init), _loss,
                                      Adam(learning_rate=0.05), mesh=m,
                                      wire_dtype="f32", chunk=8)
        step(torch.from_numpy(x), torch.from_numpy(y))
        tck.save_train_state(step, str(tmp_path / "port"), commit=True)
    LoopbackWorld(2).run(fn)
    ref, port = _meta(tmp_path / "ref"), _meta(tmp_path / "port")

    def unstamped(meta):
        for rec in meta["leaves"]:
            for sh in rec["shards"]:
                sh.pop("crc32")
        return meta
    assert unstamped(port) == unstamped(ref)
    assert sorted(_files(tmp_path / "port")) == sorted(
        _files(tmp_path / "ref"))
    want = jck.load_sharded(str(tmp_path / "ref"))
    got = jck.load_sharded(str(tmp_path / "port"))
    for n, slots in want["opt_states"].items():
        for k, v in slots.items():
            np.testing.assert_allclose(got["opt_states"][n][k], v,
                                       rtol=TOL, atol=TOL, err_msg=n + k)
    steps = []
    for cls in ("replicated", "zero"):
        if cls == "replicated":
            s = TrainStep(_mlp(init), _loss, Adam(learning_rate=0.05))
        else:
            s = ShardedUpdateTrainStep(
                _mlp(init), _loss, Adam(learning_rate=0.05),
                mesh=_one_rank_mesh(), wire_dtype="f32", chunk=8)
        tck.load_train_state(s, str(tmp_path / "ref"))
        s(torch.from_numpy(x), torch.from_numpy(y))
        steps.append(_params(s.model))
    _close(steps[0], steps[1])


def _one_rank_mesh():
    from paddle_tpu_torch.parallel.mesh import Mesh, _LoopbackGroup
    return Mesh({"dp": 1}, _LoopbackGroup(LoopbackWorld(1), (0,), 0))


def _small_step(seed=0):
    torch.manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(7, 5), torch.nn.Tanh(),
                            torch.nn.Linear(5, 1))
    return TrainStep(m, _loss, Adam(learning_rate=0.05))


def _train(step, n, seed=0):
    x, y = _data(seed)
    for _ in range(n):
        step(torch.from_numpy(x), torch.from_numpy(y))


def test_async_save_is_the_sync_save_while_training(tmp_path):
    """An async save, with the next steps taken while it writes, is the
    sync save of the same moment byte for byte; an async save across
    ranks raises."""
    step = _small_step()
    _train(step, 2)
    tck.save_train_state(step, str(tmp_path / "sync"), commit=True)
    h = tck.save_train_state(step, str(tmp_path / "async"), mode="async",
                             commit=True)
    _train(step, 3, seed=1)
    assert h.wait() and h.committed
    tck.wait_pending_saves()
    assert _files(tmp_path / "async") == _files(tmp_path / "sync")
    assert _meta(tmp_path / "async") == _meta(tmp_path / "sync")

    def fn(rank, mesh):
        z = ShardedUpdateTrainStep(_small_step().model, _loss,
                                   Adam(learning_rate=0.05), mesh=mesh)
        with pytest.raises(ValueError, match="more than one rank"):
            tck.save_train_state(z, str(tmp_path / "z"), mode="async")
    LoopbackWorld(2).run(fn)


def test_generations_retention_and_corruption_walk(tmp_path):
    """CheckpointManager: keep_last = 2 reaps the oldest committed
    generation; an uncommitted directory is skipped; a flipped byte in
    the newest generation's shard walks the restore back one generation
    (ckpt_fallback_total, a ckpt.fallback flight event), and the
    reference's manager over the same root picks the same generation."""
    root = str(tmp_path / "gens")
    with clean_planes():
        mgr = tdur.CheckpointManager(root, keep_last=2)
        step = _small_step()
        saved = {}
        for gen in (1, 2, 3):
            _train(step, 1, seed=gen)
            mode = "async" if gen == 3 else "sync"
            h = mgr.save(step, gen, mode=mode)
            if h is not None:
                h.wait()
            saved[gen] = {n: p.detach().clone()
                          for n, p in step.model.named_parameters()}
        tck.wait_pending_saves()
        import time
        for _ in range(100):                 # async GC runs on its thread
            if mgr.generations() == [2, 3]:
                break
            time.sleep(0.05)
        assert mgr.generations() == [2, 3]
        os.makedirs(mgr.generation_dir(4))         # torn: no COMMIT
        assert mgr.latest_verified() == 3
        shard = sorted(f for f in os.listdir(mgr.generation_dir(3))
                       if f.endswith(".npy"))[0]
        path = os.path.join(mgr.generation_dir(3), shard)
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        fresh = _small_step(seed=5)
        assert mgr.restore(fresh) == 2
        for n, p in fresh.model.named_parameters():
            assert torch.equal(p.detach(), saved[2][n]), n
        assert PORT.monitor.get_stat("ckpt_fallback_total") >= 1
        assert PORT.obs.flight.recent(10, kind="ckpt.fallback")
        assert jdur.CheckpointManager(root).latest_verified() == 2


def test_train_epoch_range_resumes(tmp_path):
    """TrainEpochRange over 4 epochs, the job killed after epoch 1: the
    rerun skips epochs 0-1, restores the step and trains on to the state
    of an uninterrupted run bitwise; the reference's latest_checkpoint
    reads the port's slots."""
    ckdir = str(tmp_path / "acp")
    want = _small_step()
    for epoch in range(4):
        _train(want, 1, seed=epoch)
    step = _small_step()
    for epoch in tacp.TrainEpochRange(4, "job", train_step=step,
                                      checkpoint_dir=ckdir):
        _train(step, 1, seed=epoch)
        if epoch == 1:
            break                  # killed before epoch 1's save
    # epoch 1's save runs only when the loop resumes: the kill lost it
    assert tacp.latest_checkpoint(ckdir)[1] == 0
    assert jacp.latest_checkpoint(ckdir)[1] == 0
    step2 = _small_step(seed=9)
    r = tacp.TrainEpochRange(4, "job", train_step=step2,
                             checkpoint_dir=ckdir)
    assert r.restored_epoch == 0
    seen = []
    for epoch in r:
        seen.append(epoch)
        _train(step2, 1, seed=epoch)
    assert seen == [1, 2, 3]
    for (n, p), q in zip(step2.model.named_parameters(),
                         want.model.parameters()):
        assert torch.equal(p.detach(), q.detach()), n
    assert tacp.latest_checkpoint(ckdir)[1] == 3
    assert jacp.latest_checkpoint(ckdir)[1] == 3


def test_local_fs_and_savers(tmp_path):
    """LocalFS in both packages: atomic_write leaves no tmp file and the
    same listing; HDFSClient without a hadoop binary raises in both;
    fleet's savers raise as the reference's do."""
    for pkg, fs in (("ref", jfs), ("port", tfs)):
        root = str(tmp_path / pkg)
        lfs = fs.LocalFS()
        lfs.mkdirs(os.path.join(root, "a", "b"))
        lfs.atomic_write(os.path.join(root, "a", "f.json"), b"{}")
        lfs.touch(os.path.join(root, "g"))
        assert lfs.ls_dir(root) == (["a"], ["g"])
        assert lfs.ls_dir(os.path.join(root, "a")) == (["b"], ["f.json"])
        fs.fsync_dir(root)
        with pytest.raises(Exception):
            fs.HDFSClient("/nonexistent/hadoop", {})
    with pytest.raises(NotImplementedError, match="jit.save"):
        fleet.save_inference_model()
    with pytest.raises(NotImplementedError, match="save"):
        fleet.save_persistables()


def test_emergency_save_on_sigterm(tmp_path):
    """arm_emergency_save registers a SIGTERM callback that commits one
    generation at get_generation(), as the crash handler's hook runs it
    (its deadline-bounded runner); disarming removes it."""
    from paddle_tpu_torch.framework import observability as tobs
    with clean_planes():
        mgr = tdur.CheckpointManager(str(tmp_path / "em"))
        step = _small_step()
        _train(step, 1)
        mgr.arm_emergency_save(step, lambda: 7, deadline=30.0)
        try:
            tobs._run_sigterm_callbacks()
        finally:
            assert mgr.disarm_emergency_save()
        assert mgr.generations() == [7] and mgr.latest_verified() == 7
        assert PORT.monitor.get_stat("ckpt_emergency_saves_total") == 1
        assert not mgr.disarm_emergency_save()
