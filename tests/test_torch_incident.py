"""The port's postmortem plane (paddle_tpu_torch/framework/incident.py and
paddle_tpu_torch/tools/replay.py) against the reference's on the CPU.

Each package runs its resilient two-branch step (the port's from the
reference builder's weights, ``torch_incident_common``) with
``FLAGS_incident`` and ``FLAGS_numerics`` armed, a ring of 2, and
``train.step_grads`` poisoning the aux input at the 3rd call.  Each
captures one bundle naming ``first_bad_leaf`` alike, with the same ring
steps and the same trajectory leaf names.  Each package's
``verify_bundle`` accepts the other's bundle and refuses a torn one (no
COMMIT, a flipped byte in a ring file, a truncated manifest) with the
same problems.  Each package's replay tool reproduces its own bundle's
``first_bad_leaf``, and ``--bisect`` names the same step and leaf.
Disarmed, nothing is ringed or captured.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import incident as jinc
from paddle_tpu_torch.framework import incident as tinc
from paddle_tpu_torch.tools import replay as treplay

import torch_incident_common as common
from torch_planes_common import PORT, REF, clean_planes

import replay as jreplay                       # tools/replay.py
import health_check                            # tools/health_check.py


def _flags(root):
    return {"incident": True, "numerics": True, "incident_ring": 2,
            "incident_dir": str(root), "incident_state_cap_mb": 64.0,
            "incident_kinds": ""}


def _run(pkg, inc, root, to_tensor, builder, n_steps=6, nth=3):
    inc.reset()
    inc.recorder.captured_total = 0
    with clean_planes(_flags(root)):
        step = builder(seed=0)
        x, z, y = (to_tensor(a) for a in common.batch())
        pkg.chaos.arm("train.step_grads", mode="nan", nth=nth, n_times=1,
                      payload_index=1)
        losses = [float(step(x, z, y)) for _ in range(n_steps)]
        pkg.chaos.reset(0)
        inc.uninstall()
        return losses, step, inc.recorder.last_bundle, \
            inc.recorder.captured_total


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("incidents")
    ref = _run(REF, jinc, root / "ref", paddle.to_tensor,
               health_check.build_incident_step)
    port = _run(PORT, tinc, root / "port", torch.from_numpy,
                common.port_build_incident_step)
    return ref, port, root


def test_each_package_captures_one_bundle_alike(bundles):
    (jl, _, jb, jn), (tl, tstep, tb, tn), _ = bundles
    assert jn == tn == 1
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    jm, tm = jinc.read_manifest(jb), tinc.read_manifest(tb)
    assert tm["event"]["kind"] == jm["event"]["kind"] == "train.nan_skip"
    assert tm["event"]["attrs"]["first_bad_leaf"] == \
        jm["event"]["attrs"]["first_bad_leaf"] == "aux_w"
    assert [e["step"] for e in tm["ring"]] == [e["step"] for e in jm["ring"]]
    assert tm["state"]["inline"] and jm["state"]["inline"]
    for a, b in zip(tm["trajectory"], jm["trajectory"]):
        assert sorted(a["pre_hashes"]) == sorted(b["pre_hashes"])
    assert sorted(tm["post_hashes"]) == sorted(jm["post_hashes"])
    assert tm["chaos"] == jm["chaos"]
    assert tstep.skipped_steps == 1 and tstep.last_bad_leaf == "aux_w"


def test_verify_crosses_and_refuses_torn_bundles_alike(bundles, tmp_path):
    (_, _, jb, _), (_, _, tb, _), _ = bundles
    for b in (jb, tb):
        assert jinc.verify_bundle(b) == [] == tinc.verify_bundle(b)
    for b, tag in ((jb, "ref"), (tb, "port")):
        no_commit = tmp_path / f"{tag}_nocommit"
        shutil.copytree(b, no_commit)
        os.remove(no_commit / "COMMIT")
        flipped = tmp_path / f"{tag}_flipped"
        shutil.copytree(b, flipped)
        ring = flipped / "ring_e0_in0.npy"
        data = bytearray(ring.read_bytes())
        data[-1] ^= 0xFF
        ring.write_bytes(bytes(data))
        torn = tmp_path / f"{tag}_torn"
        shutil.copytree(b, torn)
        man = torn / "manifest.json"
        man.write_bytes(man.read_bytes()[:-7])
        for d in (no_commit, flipped, torn):
            want = jinc.verify_bundle(str(d))
            assert want and tinc.verify_bundle(str(d)) == want


def _tool(capsys, main, args):
    rc = main(args)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, out


def test_replay_and_bisect_name_the_same_step(bundles, capsys):
    (_, _, jb, _), (_, _, tb, _), root = bundles
    got = {}
    for pkg, main, b in ((REF, jreplay.main, jb), (PORT, treplay.main, tb)):
        with clean_planes({"incident": False, "numerics": False,
                           "incident_dir": str(root / "replays")}):
            rc, line = _tool(capsys, main, [b])
            assert rc == 0 and line.startswith(
                "REPLAY_REPRODUCED kind=train.nan_skip "
                "first_bad_leaf=aux_w"), line
            pkg.chaos.reset(0)
            rc, line = _tool(capsys, main, [b, "--bisect"])
            assert rc == 0, line
            got[pkg is PORT] = line.rsplit(" incident=", 1)[0]
            pkg.chaos.reset(0)
    assert got[True] == got[False] == "BISECT_DIVERGENCE step=2 leaf=aux_w"


def test_refused_bundle_and_missing_program(bundles, tmp_path, capsys):
    (_, _, _, _), (_, _, tb, _), _ = bundles
    d = tmp_path / "nocommit"
    shutil.copytree(tb, d)
    os.remove(d / "COMMIT")
    with pytest.raises(SystemExit) as e:
        treplay.main([str(d)])
    assert e.value.code == 2
    assert capsys.readouterr().out.startswith("REPLAY_REFUSED")


def test_disarmed_rings_and_captures_nothing(tmp_path):
    tinc.reset()
    before = tinc.recorder.captured_total
    with clean_planes({"incident": False, "numerics": True,
                       "incident_dir": str(tmp_path)}):
        step = common.port_build_incident_step(seed=0)
        x, z, y = (torch.from_numpy(a) for a in common.batch())
        PORT.chaos.arm("train.step_grads", mode="nan", nth=1, n_times=1,
                       payload_index=1)
        step(x, z, y)
        PORT.chaos.reset(0)
    assert tinc.recorder._ring is None
    assert tinc.recorder.captured_total == before
    assert not os.listdir(tmp_path)


def _durable_bundle(root, every, nth):
    """The port's two-branch run with a ring of 2, the state over the
    cap (so the bundle references a generation), generations saved every
    ``every`` good steps, and the poison at call ``nth``: the bundle."""
    from paddle_tpu_torch.distributed.durable import CheckpointManager
    tinc.reset()
    flags = dict(_flags(root / "bundles"), incident_state_cap_mb=1e-6)
    with clean_planes(flags):
        step = common.port_build_incident_step(seed=0)
        step.attach_durable(CheckpointManager(str(root / "gens"),
                                              keep_last=10),
                            every=every, mode="sync", arm_preemption=False)
        x, z, y = (torch.from_numpy(a) for a in common.batch())
        PORT.chaos.arm("train.step_grads", mode="nan", nth=nth, n_times=1,
                       payload_index=1)
        for _ in range(nth):
            step(x, z, y)
        PORT.chaos.reset(0)
        tinc.uninstall()
        return tinc.recorder.last_bundle


def test_generation_reference_is_the_rings_first_step(tmp_path, capsys):
    """Over the cap, the bundle references the generation saved at the
    ring's first step (1 of the generations 1 and 2: the reference's
    newest, 2, would replay step 2 twice) and replays from it; with no
    generation at the ring's first step (every 2nd step saved, ring
    [3, 4]) the bundle holds no reference (the generation at step 2 would
    skip step 3) and the replay refuses.  A restored state at another
    step than the ring's first is refused by name."""
    b = _durable_bundle(tmp_path / "a", every=1, nth=3)
    m = tinc.read_manifest(b)
    assert [e["step"] for e in m["ring"]] == [1, 2]
    assert not m["state"]["inline"]
    assert m["state"]["ref"]["generation"] == 1
    with clean_planes({"incident": False, "numerics": False}):
        rc, line = _tool(capsys, treplay.main, [b, "--bisect"])
        PORT.chaos.reset(0)
    assert rc == 0 and line.startswith(
        "BISECT_DIVERGENCE step=2 leaf=aux_w"), line

    old = _durable_bundle(tmp_path / "b", every=2, nth=5)
    m_old = tinc.read_manifest(old)
    assert [e["step"] for e in m_old["ring"]] == [3, 4]
    assert m_old["state"] == {"inline": False, "ref": None}
    with clean_planes({"incident": False, "numerics": False}):
        with pytest.raises(SystemExit) as e:
            treplay.main([old])
    assert e.value.code == 2
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "REPLAY_REFUSED bundle has neither inline state nor a "
        "checkpoint generation ref")

    wrong = dict(m, state={"inline": False, "ref": dict(
        m["state"]["ref"], generation=2)})
    with clean_planes({"incident": False, "numerics": False}):
        step = common.port_build_incident_step(seed=0)
        with pytest.raises(SystemExit) as e:
            treplay.restore_state(step, wrong, b)
    assert e.value.code == 2
    assert capsys.readouterr().out.splitlines()[-1] == (
        "REPLAY_REFUSED restored state is at step 2, the ring starts at "
        "step 1 (replaying would skip or repeat steps)")
