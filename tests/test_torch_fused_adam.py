"""Port fused Adam (paddle_tpu_torch.ops.cuda.fused_adam) against the
reference on the CPU: the Pallas ``fused_adam_update`` in interpret mode
and its ``xla_reference``, one tensor at a time, against the port's plain
multi-tensor version over all of them at once; then the optimizers'
``use_fused=True`` update against the reference's.

The same numpy draws feed both.  Tolerance 1e-6 (absolute and relative):
the rules are the same f32 arithmetic, except that ``xla_reference``
rounds 1 - beta from a Python float where the Pallas kernel and the port
round it in f32, and the kernel squares g before it scales it.  In bf16
storage (``decorate(level="O2")``'s parameters and moments) every output
of a step from the same inputs is within 1 bf16 ulp of the Pallas
kernel's, plus 1 f32 ulp of the sum's largest input: in interpret mode
XLA's CPU backend fuses b1 m + (1 - b1) g into a multiply-add, where the
port rounds each product as its CUDA kernel does, and the two differ by
more than a bf16 ulp only where the sum cancels.  At most 1 % of those
values may differ at all (0.3 % do).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import optimizer as jopt
from paddle_tpu.ops.pallas import fused_adam as jfadam
from paddle_tpu_torch.ops.cuda import fused_adam as tfadam
from paddle_tpu_torch.optimizer import Adam, AdamW

TOL = 1e-6
B1, B2, EPS = 0.9, 0.999, 1e-8
LR, COEFF = 1e-3, 0.01
STEPS = 3


@pytest.fixture(autouse=True)
def _interpret():
    jfadam._INTERPRET = True
    yield
    jfadam._INTERPRET = False


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _lr_t(step):
    b1p, b2p = np.float32(B1) ** step, np.float32(B2) ** step
    return np.float32(LR) * np.sqrt(np.float32(1) - b2p) / (np.float32(1)
                                                            - b1p)


# sizes that divide the kernel's 128 lanes and sizes that do not
@pytest.mark.parametrize("shapes", [[(256, 128), (128,)],
                                    [(1000,), (3, 7, 5), (100003,)],
                                    [(50, 128), (1,), (129, 3)]])
def test_plain_matches_reference_over_steps(shapes):
    ps = _draw(shapes, 0)
    ms = [np.zeros_like(p) for p in ps]
    vs = [np.zeros_like(p) for p in ps]
    ref = {"kernel": [list(map(jnp.asarray, x)) for x in (ps, ms, vs)],
           "xla": [list(map(jnp.asarray, x)) for x in (ps, ms, vs)]}
    port = [[torch.from_numpy(a.copy()) for a in x] for x in (ps, ms, vs)]
    wd_lr = np.float32(LR) * np.float32(COEFF)
    for step in range(1, STEPS + 1):
        gs = _draw(shapes, step)
        lr_t = _lr_t(step)
        for name, fn in (("kernel", jfadam.fused_adam_update),
                         ("xla", jfadam.xla_reference)):
            p, m, v = ref[name]
            out = [fn(p[i], jnp.asarray(gs[i]), m[i], v[i], lr_t=lr_t,
                      beta1=B1, beta2=B2, eps=EPS, wd_lr=wd_lr)
                   for i in range(len(shapes))]
            ref[name] = [list(x) for x in zip(*out)]
        port = tfadam.fused_adam(
            *port[:1], [torch.from_numpy(g) for g in gs], *port[1:],
            torch.full((len(shapes),), float(lr_t)), torch.tensor(wd_lr),
            B1, B2, EPS)
        port = [list(x) for x in port]
    for name in ("kernel", "xla"):
        for got, want in zip(port, ref[name]):
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=TOL, rtol=TOL, err_msg=name)


def _ulp(x, bits):
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1), e - bits)


# beta2 = 0.99 (0.98828125 in bf16) so that lr_t is above 0, as under
# decorate O2 with the default 0.999 it is not
@pytest.mark.parametrize("shapes", [[(256, 128), (128,)],
                                    [(1000,), (3, 7, 5), (129, 3)]])
def test_plain_bf16_matches_reference_kernel(shapes):
    b2 = 0.99
    bf = jnp.bfloat16
    ps = [jnp.asarray(p * 0.02, bf) for p in _draw(shapes, 0)]
    ms = [jnp.zeros(s, bf) for s in shapes]
    vs = [jnp.zeros(s, bf) for s in shapes]
    wd_lr = np.float32(LR) * np.float32(COEFF)
    moved = 0
    for step in range(1, STEPS + 1):
        gs = [jnp.asarray(g * 1e-2, bf) for g in _draw(shapes, step)]
        b1p, b2p = np.float32(B1) ** step, np.float32(b2) ** step
        lr_t = np.float32(LR) * np.sqrt(np.float32(1) - b2p) / (
            np.float32(1) - b1p)
        want = [jfadam.fused_adam_update(p, g, m, v, lr_t=lr_t, beta1=B1,
                                         beta2=b2, eps=EPS, wd_lr=wd_lr)
                for p, g, m, v in zip(ps, gs, ms, vs)]
        port = [[torch.from_numpy(np.asarray(a).astype(np.float32))
                 .bfloat16() for a in x] for x in (ps, gs, ms, vs)]
        got = tfadam.fused_adam(*port, torch.full((len(shapes),),
                                                  float(lr_t)),
                                torch.tensor(wd_lr), B1, b2, EPS)
        for i, w in enumerate(want):
            f32 = [np.asarray(x[i]).astype(np.float32)
                   for x in (ps, gs, ms, vs)]
            terms = (np.abs(f32[0]), np.maximum(np.abs(f32[2]),
                                                np.abs(f32[1])),
                     np.maximum(f32[3], f32[1] * f32[1]))
            for name, a, b, t in zip("pmv", (x[i] for x in got), w, terms):
                assert a.dtype == torch.bfloat16 and b.dtype == bf
                a = a.float().numpy()
                b = np.asarray(b).astype(np.float32)
                tol = _ulp(np.maximum(np.abs(a), np.abs(b)), 8) + _ulp(t, 24)
                assert (np.abs(a - b) <= tol).all(), (step, i, name)
                # and bitwise equal but for a few: a store that truncates
                # instead of rounding to nearest would miss half
                assert (a != b).mean() <= 1e-2, (step, i, name)
            moved += int((np.asarray(w[0]) != np.asarray(ps[i])).sum())
        ps, ms, vs = (list(x) for x in zip(*want))
    assert moved > 0


def test_out_writes_into_the_given_storage():
    shapes = [(64, 3), (17,)]
    ps, gs = _draw(shapes, 1), _draw(shapes, 2)
    args = dict(lr_t=torch.full((2,), 1e-2), wd_lr=torch.tensor(1e-4),
                beta1=B1, beta2=B2, eps=EPS)
    fresh = tfadam.fused_adam(
        [torch.from_numpy(p) for p in ps], [torch.from_numpy(g) for g in gs],
        [torch.zeros(s) for s in shapes], [torch.zeros(s) for s in shapes],
        **args)
    p_in = [torch.from_numpy(p.copy()) for p in ps]
    m_in = [torch.zeros(s) for s in shapes]
    v_in = [torch.zeros(s) for s in shapes]
    got = tfadam.fused_adam(p_in, [torch.from_numpy(g) for g in gs], m_in,
                            v_in, out=(p_in, m_in, v_in), **args)
    for new, given, want in zip(got, (p_in, m_in, v_in), fresh):
        for a, b, c in zip(new, given, want):
            assert a is b
            assert torch.equal(a, c)


def test_other_devices_raise():
    t = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfadam.fused_adam([t], [t], [t], [t], torch.ones(1), torch.zeros(()),
                          B1, B2, EPS)


def _functional_run(make_ref, make_port, donate):
    shapes = {"w": (33, 8), "b": (8,)}
    params = {n: _draw([s], 7)[0] for n, s in shapes.items()}
    jo, to = make_ref(), make_port()
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    js, ts = jo.functional_init_states(jp), to.functional_init_states(tp)
    storage = {n: t.data_ptr() for n, t in tp.items()}
    for step in range(STEPS):
        grads = {n: _draw([s], 10 + step)[0] for n, s in shapes.items()}
        jp, js = jo.functional_update(
            jp, {n: jnp.asarray(g) for n, g in grads.items()}, js,
            lr=np.float32(LR))
        tp, ts = to.functional_update(
            tp, {n: torch.from_numpy(g) for n, g in grads.items()}, ts,
            lr=torch.tensor(LR), donate=donate)
    for n in shapes:
        assert (tp[n].data_ptr() == storage[n]) is donate
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=TOL, rtol=TOL, err_msg=n)
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(ts[n][k].numpy(), np.asarray(js[n][k]),
                                       atol=TOL, rtol=TOL, err_msg=k)
        for k in ("beta1_pow", "beta2_pow"):
            assert ts[n][k].numpy() == np.asarray(js[n][k]), (n, k)


@pytest.mark.parametrize("donate", [False, True])
def test_fused_adamw_update_matches_reference(donate):
    _functional_run(
        lambda: jopt.AdamW(learning_rate=LR, weight_decay=COEFF,
                           use_fused=True),
        lambda: AdamW(learning_rate=LR, weight_decay=COEFF, use_fused=True),
        donate)


def test_fused_adam_coupled_decay_matches_reference():
    _functional_run(
        lambda: jopt.Adam(learning_rate=LR, weight_decay=0.1,
                          use_fused=True),
        lambda: Adam(learning_rate=LR, weight_decay=0.1, use_fused=True),
        False)


def test_fused_port_update_matches_unfused_reference():
    # the same rule in one pass or in tensor arithmetic
    _functional_run(
        lambda: jopt.AdamW(learning_rate=LR, weight_decay=COEFF),
        lambda: AdamW(learning_rate=LR, weight_decay=COEFF, use_fused=True),
        False)


def test_cpu_update_counts_no_launch():
    before = tfadam.launches
    opt = AdamW(learning_rate=LR, use_fused=True)
    p = {"w": torch.ones(4, 4)}
    opt.functional_update(p, {"w": torch.ones(4, 4)},
                          opt.functional_init_states(p), lr=torch.tensor(LR))
    assert tfadam.launches == before
