"""The port's ring attention (paddle_tpu_torch/parallel/ring_attention.py)
held to the reference's ``ring_attention`` on {"sp": n} of the 8 virtual
CPU devices and to ``ring_attention_local`` (tests/test_distributed.py:
499-525).

The port's ranks are ``LoopbackWorld`` threads, rank j holding positions
[j S/n, (j + 1) S/n) of q, k and v.  Head dim 64 with S/n >= 128 takes
the flash route (on the CPU the kernels' plain versions, with lse), head
dim 16 the dense route; both merge the chunks by lse.  f32: out 1e-5,
the gradients of sum(out * cot) 1e-4.  The flash route's chunk counts are
the kernels' launch counts on the card: r + 1 forward, dq and dk/dv
chunks on rank r under causal masking, n each without.  Each planted
fault of chip_smoke.py's phase 49 reads far above the limits."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RING_FAULTS, ring_fault
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.parallel.ring_attention import ring_attention as jring
from paddle_tpu.parallel.ring_attention import ring_attention_local as jlocal
from paddle_tpu_torch.parallel import LoopbackWorld
from paddle_tpu_torch.parallel import ring_attention as ring_fn
from paddle_tpu_torch.parallel.ring_attention import (chunk_calls,
                                                      ring_attention_local)

VAL, GRAD = 1e-5, 1e-4
# (B, S, H, D): the flash route (S/n >= 128 at n = 2 and 4), the dense one
SHAPES = {"flash": (1, 512, 2, 64), "dense": (2, 16, 2, 16)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _ref(q, k, v, cot, causal, n):
    """The reference ring on {"sp": n}: out and the gradients of
    sum(out * cot) in q, k, v."""
    mesh = jmake_mesh({"sp": n})

    def f(q, k, v):
        out = jring(q, k, v, causal=causal, mesh=mesh)
        return jnp.sum(out * cot), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port(q, k, v, cot, causal, n, fault=None):
    """The port's ring on n LoopbackWorld ranks: out and the q, k, v
    gradients, the ranks' chunks concatenated; the chunk calls made.
    ``fault`` names a fault of ``chip_smoke.ring_fault`` to plant."""
    w = q.shape[1] // n
    before = dict(chunk_calls)

    def fn(rank, mesh):
        sl = slice(rank * w, (rank + 1) * w)
        xs = [torch.from_numpy(t[:, sl].copy()).requires_grad_()
              for t in (q, k, v)]
        out = ring_fn(*xs, causal=causal, mesh=mesh)
        (out * torch.from_numpy(cot[:, sl].copy())).sum().backward()
        return [out.detach().numpy()] + [x.grad.numpy() for x in xs]
    with ring_fault(fault) if fault else contextlib.nullcontext():
        got = LoopbackWorld(n).run(fn, axes={"sp": n})
    calls = {k: chunk_calls[k] - before[k] for k in chunk_calls}
    return [np.concatenate([r[i] for r in got], 1) for i in range(4)], calls


@pytest.mark.parametrize("route", ["flash", "dense"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_reference(route, causal, n):
    """Out and the q / k / v gradients as the reference's ring and its
    single-device attention; the chunk calls of the route taken."""
    q, k, v, cot = _inputs(SHAPES[route])
    want = _ref(q, k, v, cot, causal, n)
    local = jlocal(q, k, v, causal=causal)
    got, calls = _port(q, k, v, cot, causal, n)
    np.testing.assert_allclose(got[0], want[0], rtol=VAL, atol=VAL)
    np.testing.assert_allclose(got[0], np.asarray(local), rtol=VAL,
                               atol=VAL)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w_, rtol=GRAD, atol=GRAD)
    chunks = n * (n + 1) // 2 if causal else n * n
    if route == "flash":
        assert calls == {"flash_fwd": chunks, "flash_dq": chunks,
                         "flash_dkv": chunks, "dense_fwd": 0,
                         "dense_bwd": 0}
    else:
        assert calls == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                         "dense_fwd": chunks, "dense_bwd": chunks}


def test_one_rank_and_local():
    """With n = 1 the ring is one local attention (reference :43-45), and
    the port's ring_attention_local is the reference's."""
    q, k, v, cot = _inputs(SHAPES["flash"], seed=1)
    got, calls = _port(q, k, v, cot, True, 1)
    want = _ref(q, k, v, cot, True, 1)
    np.testing.assert_allclose(got[0], want[0], rtol=VAL, atol=VAL)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w_, rtol=GRAD, atol=GRAD)
    assert calls["flash_fwd"] == 1
    for causal in (True, False):
        np.testing.assert_allclose(
            ring_attention_local(*(torch.from_numpy(t) for t in (q, k, v)),
                                 causal=causal).numpy(),
            np.asarray(jlocal(q, k, v, causal=causal)), rtol=VAL, atol=VAL)


@pytest.mark.parametrize("fault,reads",
                         zip(RING_FAULTS, ("out", "out", "dq")))
def test_planted_faults_caught(fault, reads):
    """Every chunk causal, a merge without the chunks' lse, delta from the
    diagonal chunk's output: each moves what it reads far past the
    limits."""
    q, k, v, cot = _inputs(SHAPES["flash"], seed=2)
    local = torch.from_numpy(np.array(jlocal(q, k, v, causal=True)))
    qt = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (ring_attention_local(*qt, causal=True)
     * torch.from_numpy(cot)).sum().backward()
    got, _ = _port(q, k, v, cot, True, 4, fault=fault)
    err = {"out": np.abs(got[0] - local.numpy()).max(),
           "dq": np.abs(got[1] - qt[0].grad.numpy()).max()}
    assert err[reads] > 100 * GRAD, (fault, err)
