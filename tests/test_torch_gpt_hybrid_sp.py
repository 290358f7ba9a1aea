"""GPT's sequence-parallel path (ring attention over ``sp``, alone and
with ``mp``) under the port's ShardedTrainStep, held to the reference's
ShardedTrainStep on the same meshes of the 8 virtual CPU devices.

The model, batch, optimizer and limits are ``test_torch_gpt_hybrid.py``'s
(H = 128, 2 heads of 64, 2 layers, V = 256, S = 256: 128 positions a rank
at sp = 2, the ring's flash route).  Every sp rank embeds its positions of
the whole sequence it is given and builds the next-token labels from the
whole sequence, so the shift crosses the shard edge; the loss divides by
the global B (S - 1).  The reference runs once per mesh (module fixture,
7-9 s each)."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPT, GPTConfig, gpt_loss
from paddle_tpu_torch.parallel import LoopbackWorld

from test_torch_gpt_hybrid import (CFG, GRAD, VAL, _close_rel, _ids,
                                   port_run, reference_run)

MESHES = {"dp2_sp2": {"dp": 2, "sp": 2},
          "dp2_mp2_sp2": {"dp": 2, "mp": 2, "sp": 2}}


@pytest.fixture(scope="module")
def reference():
    return {name: reference_run(axes, logits=name == "dp2_sp2")
            for name, axes in MESHES.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sp_steps_match_reference(reference, mesh):
    """3 Adam steps at sp = 2 (with dp = 2, and with dp = 2 x mp = 2): the
    losses, the gathered parameters and the moments as the reference's
    step on the same mesh; every rank reads the same losses."""
    init, want_l, want_p, want_m, _ = reference[mesh]
    got = port_run(MESHES[mesh], init)
    losses, params, moments, _ = got[0]
    np.testing.assert_allclose(losses, want_l, rtol=VAL, atol=VAL)
    for n, v in want_p.items():
        np.testing.assert_allclose(params[n], v, rtol=GRAD, atol=GRAD)
        for m in ("moment1", "moment2"):
            _close_rel(moments[n][m], want_m[n][m], GRAD)
    assert all(r[0] == losses for r in got)


def test_serving_logits_sp2(reference):
    """GPT.forward at sp = 2 (and mp = 2 x sp = 2) all-gathers the
    reference's (B, S, V) logits on every rank, the loss its first."""
    init, want_l, _, _, logits = reference["dp2_sp2"]
    ids = torch.from_numpy(_ids())

    def fn(rank, mesh):
        model = GPT(GPTConfig(**CFG), device="cpu", mesh=mesh)
        model.apply_mesh(mesh)
        model.load_jax_params(init)
        with torch.inference_mode():
            return model(ids).numpy(), float(gpt_loss(model, ids, ids))
    for axes in ({"sp": 2}, {"mp": 2, "sp": 2}):
        n = int(np.prod(list(axes.values())))
        for lg, loss in LoopbackWorld(n).run(fn, axes=axes):
            np.testing.assert_allclose(lg, logits, rtol=VAL, atol=VAL)
            np.testing.assert_allclose(loss, want_l[0], rtol=VAL, atol=VAL)
