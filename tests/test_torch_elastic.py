"""The port's elastic training and launcher
(paddle_tpu_torch/distributed/{elastic,launch}.py) against the
reference's on the CPU.

* Stores: a scripted sequence of joins, renewals, clock advances,
  sweeps, leaves and re-registers drives a ``DictStore`` of each package
  under the same injected clock: the same epochs, members, endpoints,
  expiries and progress readings.
* The 4 -> 3 shrink (the reference's acceptance run): a 4-worker
  in-process data-parallel job on the port's ``TrainStep`` pieces loses
  w3's lease to an ``elastic.lease`` fault, the survivors ``reform()``
  (role refresh, restore of the latest committed ``TrainEpochRange``
  slot) and finish at 3 workers; its losses and parameters are the
  reference's same job's within 1e-4 and a clean 3-worker port run's
  within 1e-4.  The same shrink over gloo processes: 4 ``torch.
  distributed`` ranks on a ``FileStore``, w3 leaving after step 3, the 3
  survivors re-forming a new process group from the store and restoring
  the slot committed at step 2 (step 3 is trained again at 3 ranks),
  reach a clean 3-rank gloo run's final parameters within 1e-4.
* The hang watchdog: ``elastic.worker_hang`` latency trips the agent's
  progress deadline and a replacement joins, as in the reference.
* The launcher: the reference's ``tests/test_launch.py`` cases through
  ``python -m paddle_tpu_torch.distributed.launch`` (collective env and
  logs, failure propagation, PS roles, a PS failure killing the job),
  the elastic agent restarting a crashed child, and the plain path
  importing nothing of the framework.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import elastic as jel
from paddle_tpu_torch.distributed import elastic as tel

import torch_elastic_common as common
from torch_planes_common import PORT, REF, REPO, clean_planes

LAUNCH = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _store_script(mod, seed):
    rng = np.random.default_rng(seed)
    clock = Clock()
    store = mod.DictStore(ttl=3.0, clock=clock)
    log = []
    names = [f"w{i}" for i in range(5)]
    for _ in range(60):
        op = int(rng.integers(6))
        w = names[int(rng.integers(len(names)))]
        try:
            if op == 0:
                out = store.register(w, endpoint=f"h{w}:1")
            elif op == 1:
                out = store.renew(w)
            elif op == 2:
                clock.t += float(rng.uniform(0, 2))
                out = None
            elif op == 3:
                out = store.sweep()
            elif op == 4:
                out = store.leave(w)
            else:
                out = store.beat(w, step=int(rng.integers(100)))
        except Exception as e:                    # noqa: BLE001
            out = type(e).__name__
        log.append((op, w, out, store.membership(),
                    [store.progress(n) for n in names]))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_dict_store_events_equal(seed):
    assert _store_script(tel, seed) == _store_script(jel, seed)


def test_dp_shard_and_refresh_alike():
    for n, world in ((12, 4), (12, 3), (7, 3), (5, 5)):
        assert [tel.dp_shard(n, world, r) for r in range(world)] == \
            [jel.dp_shard(n, world, r) for r in range(world)]


# ---------------------------------------------------------------------------
# the 4 -> 3 shrink, in process (the reference's acceptance run)
# ---------------------------------------------------------------------------

def _ref_weights():
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn

    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(6, 12)
            self.fc2 = jnn.Linear(12, 3)
    paddle.seed(0)
    return {n: np.asarray(p._data) for n, p in MLP().named_parameters()}


def _port_job(world0, total_steps, ck_dir, ttl=3.5, lease_fault_nth=None):
    """The reference's ``_run_elastic_job`` on the port: fake clock,
    lockstep workers, a commit every 2nd step, re-form on an epoch bump."""
    from paddle_tpu_torch.distributed.fleet.role_maker import \
        PaddleCloudRoleMaker
    from paddle_tpu_torch.framework.auto_checkpoint import TrainEpochRange
    from paddle_tpu_torch.jit import (TrainStep, apply_functional_update,
                                      loss_and_grads, loss_closure)
    from paddle_tpu_torch.models import load_named_params
    from paddle_tpu_torch.optimizer import Momentum
    clock = Clock()
    store = tel.DictStore(ttl=ttl, clock=clock)
    model = common.MLP()
    load_named_params(model, _ref_weights())
    opt = Momentum(learning_rate=0.05, momentum=0.9)
    container = TrainStep(model, common.mlp_loss, opt, donate=False)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    container._opt_states = opt.functional_init_states(params)
    epoch_range = TrainEpochRange(total_steps, "elastic-job",
                                  train_step=container,
                                  checkpoint_dir=ck_dir, world_size=world0)
    rm = PaddleCloudRoleMaker(is_collective=True)
    loss_from = loss_closure(model, common.mlp_loss)
    stream = common.stream(total_steps)
    ctxs = {}
    for i in range(world0):
        w = f"w{i}"
        ctxs[w] = tel.ElasticWorkerContext(store, w, endpoint=f"h{i}:1",
                                           renew_interval=0.0)
        ctxs[w].join()
    for ctx in ctxs.values():
        ctx.resync()
    if lease_fault_nth is not None:
        PORT.chaos.arm("elastic.lease", mode="error", nth=lease_fault_nth,
                       n_times=1)
    dead, losses, reforms, stalls, t = set(), [], 0, 0, 0
    while t < total_steps:
        clock.t += 1.0
        store.sweep()
        members = store.members()
        actives = [w for w in members if w not in dead]
        if ctxs[actives[0]].membership_changed():
            for w in actives:
                store.renew(w)
            epoch, _, world, restored = tel.reform(
                store, rm, actives[0], train_step=container,
                checkpoint_dir=ck_dir)
            for w in actives:
                ctxs[w].resync(epoch)
            t = 0 if restored is None else restored + 1
            reforms += 1
            continue
        if set(actives) != set(members):
            for w in actives:
                store.renew(w)
            stalls += 1
            continue
        world = len(members)
        X, Y = (torch.from_numpy(a) for a in stream[t])
        params = {n: p for n, p in model.named_parameters()}
        tot_g, tot_loss = None, 0.0
        for rank in range(world):
            sl = tel.dp_shard(X.shape[0], world, rank)
            wgt = (sl.stop - sl.start) / X.shape[0]
            loss, g = loss_and_grads(loss_from, params, [X[sl], Y[sl]])
            tot_loss += wgt * float(loss)
            tot_g = {n: wgt * v for n, v in g.items()} if tot_g is None \
                else {n: tot_g[n] + wgt * v for n, v in g.items()}
        with torch.no_grad():
            new_p, container._opt_states = apply_functional_update(
                opt, tot_g, {n: p.detach() for n, p in params.items()},
                container._opt_states,
                torch.tensor(opt.get_lr(), dtype=torch.float32),
                donate=False)
            for n, p in params.items():
                p.copy_(new_p[n])
        losses.append(tot_loss)
        for w in list(actives):
            try:
                ctxs[w].step_done(t)
            except (PORT.chaos.InjectedFault, tel.LeaseExpired):
                dead.add(w)
        if t % 2 == 0:
            epoch_range.save_checkpoint(t)
        t += 1
    PORT.chaos.disarm("elastic.lease")
    return {"losses": losses, "reforms": reforms, "stalls": stalls,
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
            "world": len(store.members()), "epoch": store.epoch()}


@pytest.fixture(scope="module")
def reference_shrink(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_elastic as ref_t
    d = tmp_path_factory.mktemp("ref_elastic")
    REF.chaos.reset(0)
    try:
        return ref_t._run_elastic_job(4, 10, str(d / "shrunk"),
                                      lease_fault_nth=16)
    finally:
        REF.chaos.reset(0)


def test_shrink_4_to_3_matches_reference_and_clean_run(reference_shrink,
                                                       tmp_path):
    want = reference_shrink
    with clean_planes():
        shrunk = _port_job(4, 10, str(tmp_path / "shrunk"),
                           lease_fault_nth=16)
        clean = _port_job(3, 10, str(tmp_path / "clean"))
    assert shrunk["reforms"] == want["reforms"] == 1
    assert shrunk["stalls"] == want["stalls"] >= 1
    assert shrunk["world"] == want["world"] == 3
    assert shrunk["epoch"] == want["epoch"] == 5
    np.testing.assert_allclose(shrunk["losses"], want["losses"], rtol=1e-4)
    for k in want["params"]:
        np.testing.assert_allclose(shrunk["params"][k], want["params"][k],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(shrunk["params"][k], clean["params"][k],
                                   rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the 4 -> 3 shrink over gloo processes
# ---------------------------------------------------------------------------

def _gloo_job(root, world0, leave_after, steps=6):
    os.makedirs(root, exist_ok=True)
    np.savez(common.weights_file(root), **_ref_weights())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]), OMP_NUM_THREADS="1",
        CUDA_VISIBLE_DEVICES="")
    worker = os.path.join(REPO, "tests", "torch_elastic_common.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, root, f"w{i}", str(world0),
         str(leave_after), str(steps)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(world0)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return {f"w{i}": json.load(open(os.path.join(root, f"w{i}.json")))
            for i in range(world0)
            if os.path.exists(os.path.join(root, f"w{i}.json"))}


def test_shrink_4_to_3_over_gloo_processes(tmp_path):
    shrunk = _gloo_job(str(tmp_path / "shrunk"), 4, leave_after=3)
    clean = _gloo_job(str(tmp_path / "clean"), 3, leave_after=-1)
    assert sorted(shrunk) == ["w0", "w1", "w2"] == sorted(clean)
    for w in shrunk:
        assert shrunk[w]["reformed"] == 1 and shrunk[w]["world"] == 3
        for n, v in clean["w0"]["params"].items():
            np.testing.assert_allclose(shrunk[w]["params"][n], v,
                                       rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the hang watchdog
# ---------------------------------------------------------------------------

def test_hung_worker_killed_and_replaced():
    store = tel.DictStore(ttl=60.0)
    with clean_planes():
        PORT.chaos.arm("elastic.worker_hang", mode="latency", latency=3.0,
                       nth=40, n_times=1)

        def make(name):
            def target(stop):
                ctx = tel.ElasticWorkerContext(store, name)
                ctx.join()
                step = 0
                while not stop.is_set():
                    try:
                        ctx.step_done(step)
                    except (tel.LeaseExpired, PORT.chaos.InjectedFault):
                        return
                    step += 1
                    time.sleep(0.01)
            return target
        handles = [tel.LocalHandle(n, make(n)) for n in ("wa", "wb")]
        for h in handles:
            h.start()
        agent = tel.ElasticAgent(store, handles, hang_deadline=0.3,
                                 elastic_retries=2, restart_backoff=0.05)
        t0 = time.monotonic()
        try:
            while time.monotonic() - t0 < 8.0:
                agent.poll_once()
                kinds = [ev[0] for ev in agent.events]
                if "hang_killed" in kinds and "restarted" in kinds:
                    break
                time.sleep(0.02)
            assert time.monotonic() - t0 < 3.0
            assert store.members() == ["wa", "wb"]
        finally:
            for h in handles:
                h.kill()


# ---------------------------------------------------------------------------
# the launcher (the reference's tests/test_launch.py cases)
# ---------------------------------------------------------------------------

def _launch(args, cwd, timeout=120):
    return subprocess.run(LAUNCH + args, cwd=cwd, capture_output=True,
                          text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   CUDA_VISIBLE_DEVICES=""))


def test_collective_env_and_logs(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(
        "import os, sys\n"
        "print('ID', os.environ['PADDLE_TRAINER_ID'])\n"
        "print('NUM', os.environ['PADDLE_TRAINERS_NUM'])\n"
        "print('EP', os.environ['PADDLE_TRAINER_ENDPOINTS'])\n"
        "print('FW', [m for m in sys.modules if m.startswith("
        "'paddle_tpu_torch.framework')])\n")
    r = _launch(["--log_dir", str(tmp_path / "log"), str(script)],
                str(tmp_path))
    assert r.returncode == 0, r.stderr
    log = (tmp_path / "log" / "workerlog.0").read_text()
    assert "ID 0" in log and "NUM 1" in log and "127.0.0.1:6070" in log


def test_child_failure_propagates(tmp_path):
    script = tmp_path / "boom.py"
    script.write_text("import sys; print('dying'); sys.exit(3)\n")
    r = _launch(["--log_dir", str(tmp_path / "log"), str(script)],
                str(tmp_path))
    assert r.returncode == 3
    assert "exited with 3" in r.stderr
    assert "dying" in (tmp_path / "log" / "workerlog.0").read_text()


def test_ps_mode_roles_and_supervision(tmp_path):
    script = tmp_path / "ps.py"
    script.write_text(
        "import os\n"
        "role = os.environ['TRAINING_ROLE']\n"
        "print('ROLE', role,\n"
        "      os.environ.get('PADDLE_PSERVER_ID',\n"
        "                     os.environ.get('PADDLE_TRAINER_ID')))\n"
        "print('SERVERS', os.environ['PADDLE_PSERVERS_IP_PORT_LIST'])\n")
    r = _launch(["--server_num", "2", "--worker_num", "2",
                 "--log_dir", str(tmp_path / "log"), str(script)],
                str(tmp_path))
    assert r.returncode == 0, r.stderr
    s0 = (tmp_path / "log" / "serverlog.0").read_text()
    s1 = (tmp_path / "log" / "serverlog.1").read_text()
    w0 = (tmp_path / "log" / "workerlog.0").read_text()
    w1 = (tmp_path / "log" / "workerlog.1").read_text()
    assert "ROLE PSERVER 0" in s0 and "ROLE PSERVER 1" in s1
    assert "ROLE TRAINER 0" in w0 and "ROLE TRAINER 1" in w1
    assert s0.count("127.0.0.1:6070") == 1 and "6071" in s0
    assert "6070" in w0 and "6071" in w1


def test_ps_failure_kills_job(tmp_path):
    script = tmp_path / "mixed.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['TRAINING_ROLE'] == 'PSERVER':\n"
        "    time.sleep(60)\n"
        "sys.exit(5)\n")
    r = _launch(["--server_num", "1", "--worker_num", "1",
                 "--log_dir", str(tmp_path / "log"), str(script)],
                str(tmp_path))
    assert r.returncode == 5


def test_crash_restart_through_elastic_agent(tmp_path):
    marker = tmp_path / "count"
    script = tmp_path / "train.py"
    script.write_text(
        "import os, sys\n"
        "assert os.environ['PADDLE_ELASTIC_WORKER_ID']\n"
        f"p = {str(marker)!r}\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "sys.exit(1 if n == 0 else 0)\n")
    r = _launch(["--elastic_store", str(tmp_path / "es"),
                 "--elastic_retries", "1", "--restart_backoff", "0.1",
                 "--log_dir", str(tmp_path / "log"), str(script)],
                str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert marker.read_text() == "2"
    assert "restart_scheduled" in r.stderr


def test_launch_plain_path_imports_no_framework():
    """The launcher module and its plain supervision path load nothing of
    the framework (reference :184-188, :348-350)."""
    code = ("import sys; import paddle_tpu_torch.distributed.launch as L; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "'paddle_tpu_torch.framework.') and m.split('.')[-1] in "
            "('collector', 'observability', 'elastic')))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO,
                                CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    assert "collector" not in r.stdout
