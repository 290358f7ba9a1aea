"""GPT's pipeline composed with the data and sequence axes (dp x pp, pp x
sp) under the port's ShardedTrainStep, held to the reference's
ShardedTrainStep on the same meshes of the 8 virtual CPU devices.

The model, batch, optimizer, steps and limits are
``test_torch_gpt_pipeline.py``'s (pp x mp is there):
``{"dp": 2, "pp": 2}`` in mode 0 (each data group its own pipeline) and
``{"pp": 2, "sp": 2}`` in mode 0 (the ring over sp inside each stage,
128 positions a rank).  At pp x sp the reference runs
mode 0 only: its mode 1 there aborts XLA:CPU, so the port's mode 1 is
held to the port's mode 0 and both to the reference's mode 0.  The
reference runs once per mesh (module fixture, 6-9 s each)."""
import numpy as np
import pytest

from test_torch_gpt_hybrid import VAL
from test_torch_gpt_pipeline import check_run, port_run, reference_run

RUNS = {"dp2_pp2_mode0": ({"dp": 2, "pp": 2}, 0),
        "pp2_sp2_mode0": ({"pp": 2, "sp": 2}, 0)}


@pytest.fixture(scope="module")
def reference():
    return {name: reference_run(axes, mode)
            for name, (axes, mode) in RUNS.items()}


@pytest.fixture(scope="module")
def port(reference):
    """The port's 3 steps from the reference's initial weights, once per
    (mesh, mode)."""
    runs = {}

    def get(axes, mode):
        key = (tuple(axes.items()), mode)
        if key not in runs:
            runs[key] = port_run(axes, reference["dp2_pp2_mode0"][0], mode)
        return runs[key]
    return get


@pytest.mark.parametrize("run", list(RUNS))
def test_hybrid_steps_match_reference(reference, port, run):
    """3 Adam steps at dp x pp and pp x sp (F-then-B): the
    losses, the gathered parameters and the moments as the reference's
    step on the same mesh and mode; every rank the same losses."""
    axes, mode = RUNS[run]
    check_run(port(axes, mode), reference[run], axes, mode)


def test_pp_sp_1f1b(reference, port):
    """1F1B at pp x sp: within 1e-5 of the port's F-then-B (losses,
    gathered parameters) and held to the reference's F-then-B as that
    is."""
    axes = RUNS["pp2_sp2_mode0"][0]
    want = reference["pp2_sp2_mode0"]
    one, zero = port(axes, 1), port(axes, 0)
    np.testing.assert_allclose(one[0][0], zero[0][0], rtol=VAL, atol=VAL)
    for n, v in zero[0][1].items():
        np.testing.assert_allclose(one[0][1][n], v, rtol=VAL, atol=VAL)
    check_run(one, want, axes, 1)

