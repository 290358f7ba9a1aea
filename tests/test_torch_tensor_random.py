"""The port's tensor/random.py on the CPU against the reference's
distributions (the streams differ: JAX's threefry draws are not
reproduced).  Each sampler: the same seed gives the same draws; its
output dtype and shape are the reference's; its sample mean and variance
lie within 6 sigma of the distribution's, as the reference's own draws
do.  ``uniform(seed=k)`` ignores the default stream; ``seed(0)`` makes
layer initialisation repeatable; ``get_rng_state`` / ``set_rng_state``
replay a draw; ``multinomial`` without replacement accepts a row with
fewer non-zero entries than ``num_samples`` and a row of zeros, the
latter of which ``torch.multinomial`` refuses."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch as tpt
import paddle_tpu_torch.tensor as T
from paddle_tpu_torch import nn as tnn

from torch_tensor_common import dtype_name

N = 20_000
CPU = {"device": "cpu"}
P = np.array([[0.1, 0.2, 0.3, 0.4], [1.0, 1.0, 0.0, 2.0]], np.float32)


def _port_draw(name):
    rates = torch.full((N,), 3.0)
    probs = torch.full((N,), 0.3)
    return {
        "rand": lambda: T.rand([N], **CPU),
        "randn": lambda: T.randn([N], **CPU),
        "standard_normal": lambda: T.standard_normal([N], **CPU),
        "randint": lambda: T.randint(-3, 5, [N], **CPU),
        "randint_like": lambda: T.randint_like(torch.zeros(N, dtype=torch.
                                                           int32), 0, 7),
        "uniform": lambda: T.uniform([N], min=-2.0, max=3.0, **CPU),
        "normal": lambda: T.normal(1.5, 2.0, [N], **CPU),
        "poisson": lambda: T.poisson(rates),
        "bernoulli": lambda: T.bernoulli(probs),
        "multinomial": lambda: T.multinomial(torch.from_numpy(P), 2),
        "randperm": lambda: T.randperm(N, **CPU),
        "uniform_": lambda: T.uniform_(torch.empty(N), 0.5, 1.5),
        "normal_": lambda: T.normal_(torch.empty(N), -1.0, 0.5),
        "exponential_": lambda: T.exponential_(torch.empty(N), 2.0),
    }[name]()


def _ref_draw(name):
    rates = paddle.to_tensor(np.full(N, 3.0, np.float32))
    probs = paddle.to_tensor(np.full(N, 0.3, np.float32))
    return {
        "rand": lambda: J.rand([N]),
        "randn": lambda: J.randn([N]),
        "standard_normal": lambda: J.standard_normal([N]),
        "randint": lambda: J.randint(-3, 5, [N]),
        "randint_like": lambda: J.randint_like(
            paddle.to_tensor(np.zeros(N, np.int32)), 0, 7),
        "uniform": lambda: J.uniform([N], min=-2.0, max=3.0),
        "normal": lambda: J.normal(1.5, 2.0, [N]),
        "poisson": lambda: J.poisson(rates),
        "bernoulli": lambda: J.bernoulli(probs),
        "multinomial": lambda: J.multinomial(paddle.to_tensor(P), 2),
        "randperm": lambda: J.randperm(N),
        "uniform_": lambda: J.uniform_(paddle.to_tensor(np.zeros(N,
                                                                 np.float32)),
                                       0.5, 1.5),
        "normal_": lambda: J.normal_(paddle.to_tensor(np.zeros(N, np.float32)),
                                     -1.0, 0.5),
        "exponential_": lambda: J.exponential_(paddle.to_tensor(
            np.zeros(N, np.float32)), 2.0),
    }[name]()


@pytest.fixture(autouse=True)
def _keep_the_streams():
    """Leave torch's CPU stream and the reference's key as they were."""
    cpu, key = torch.get_rng_state(), J.get_rng_state()
    yield
    torch.set_rng_state(cpu)
    J.set_rng_state(key)


# (mean, variance) of each distribution
MOMENTS = {"rand": (0.5, 1 / 12), "randn": (0.0, 1.0),
           "standard_normal": (0.0, 1.0), "randint": (0.5, (8 ** 2 - 1) / 12),
           "randint_like": (3.0, (7 ** 2 - 1) / 12),
           "uniform": (0.5, 25 / 12), "normal": (1.5, 4.0),
           "poisson": (3.0, 3.0), "bernoulli": (0.3, 0.21),
           "uniform_": (1.0, 1 / 12), "normal_": (-1.0, 0.25),
           "exponential_": (0.5, 0.25)}
SAMPLERS = sorted(MOMENTS) + ["multinomial", "randperm"]


def _moments_ok(a, mean, var):
    a = np.asarray(a, np.float64)
    n = a.size
    sd_mean = math.sqrt(var / n)
    sd_var = var * math.sqrt(2.0 / (n - 1)) * 1.5   # a margin for tails
    return (abs(a.mean() - mean) < 6 * sd_mean
            and abs(a.var() - var) < 6 * sd_var + 1e-12)


@pytest.mark.parametrize("name", SAMPLERS)
def test_same_seed_same_draws(name):
    tpt.seed(7)
    a = _port_draw(name)
    tpt.seed(7)
    assert torch.equal(a, _port_draw(name))
    tpt.seed(8)
    assert not torch.equal(a, _port_draw(name))


@pytest.mark.parametrize("name", sorted(MOMENTS) + ["multinomial",
                                                    "randperm"])
def test_the_reference_dtype_shape_and_moments(name):
    tpt.seed(11)
    paddle.seed(11)
    got, want = _port_draw(name), _ref_draw(name)
    assert dtype_name(got) == dtype_name(want), name
    assert tuple(got.shape) == tuple(want.shape)
    if name not in MOMENTS:
        return
    mean, var = MOMENTS[name]
    want = np.asarray(want._data, np.float64)
    assert _moments_ok(want, mean, var), "the reference's own draws"
    assert _moments_ok(got.float().numpy(), mean, var), name
    if name.startswith("randint"):
        assert set(np.unique(got.numpy())) == set(np.unique(want))


def test_randperm_is_a_permutation():
    assert torch.equal(torch.sort(T.randperm(1000, **CPU)).values,
                       torch.arange(1000))


def test_randint_low_alone_is_the_high():
    tpt.seed(3)
    x = T.randint(4, shape=[5000], **CPU)
    assert int(x.min()) == 0 and int(x.max()) == 3


def test_default_dtypes_follow_set_default_dtype():
    prev = tpt.get_default_dtype()
    try:
        tpt.set_default_dtype("float64")
        for fn in (T.rand, T.randn, T.uniform):
            assert fn([3], **CPU).dtype == torch.float64
        assert T.normal(0.0, 1.0, [3], **CPU).dtype == torch.float64
    finally:
        tpt.set_default_dtype(prev)
    assert T.rand([3], **CPU).dtype == torch.float32
    assert T.randint(0, 3, [3], **CPU).dtype == torch.int64
    assert T.randperm(3, **CPU).dtype == torch.int64
    assert T.rand([3], dtype="bfloat16", **CPU).dtype == torch.bfloat16


def test_uniform_seed_ignores_the_default_stream():
    a = T.uniform([64], seed=5, **CPU)
    T.rand([10], **CPU)
    tpt.seed(123)
    assert torch.equal(a, T.uniform([64], seed=5, **CPU))
    assert not torch.equal(a, T.uniform([64], seed=6, **CPU))


def test_normal_broadcasts_tensor_mean_and_std():
    mean = torch.tensor([[0.0], [10.0]])
    std = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float64)
    out = T.normal(mean, std)
    want = J.normal(paddle.to_tensor(mean.numpy()),
                    paddle.to_tensor(std.numpy()))
    assert tuple(out.shape) == tuple(want.shape) == (2, 3)
    assert dtype_name(out) == dtype_name(want) == "float64"
    assert torch.equal(out[:, 1], mean[:, 0].double())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_samplers_keep_the_input_dtype(dtype):
    x = torch.full((16,), 0.5, dtype=getattr(torch, dtype))
    for fn in (T.poisson, T.bernoulli):
        assert fn(x).dtype == x.dtype
    assert T.exponential_(x.clone()).dtype == x.dtype


def test_seed_makes_initialisation_repeatable():
    tpt.seed(0)
    a = tnn.Linear(16, 8, device="cpu")
    tpt.seed(0)
    b = tnn.Linear(16, 8, device="cpu")
    assert torch.equal(a.weight, b.weight)
    tpt.seed(1)
    assert not torch.equal(a.weight, tnn.Linear(16, 8, device="cpu").weight)


def test_rng_state_replays_a_draw():
    tpt.seed(4)
    state = tpt.get_rng_state("cpu")
    a = T.multinomial(torch.from_numpy(P), 2)
    b = T.randn([8], **CPU)
    tpt.set_rng_state(state, "cpu")
    assert torch.equal(T.multinomial(torch.from_numpy(P), 2), a)
    assert torch.equal(T.randn([8], **CPU), b)
    assert isinstance(state, torch.Tensor) and state.dtype == torch.uint8


def test_generator():
    g = T.Generator(5, device="cpu")
    assert g.initial_seed() == 5
    s = g.get_state()
    x = torch.rand(4, generator=g.generator("cpu"))
    g.set_state(s)
    assert torch.equal(x, torch.rand(4, generator=g.generator("cpu")))
    g.manual_seed(6)
    assert g.initial_seed() == 6
    assert tpt.default_generator is T.default_generator
    assert isinstance(tpt.default_generator, tpt.Generator)
    assert tpt.seed(9) is tpt.default_generator
    assert tpt.default_generator.initial_seed() == 9 == torch.initial_seed()


@pytest.mark.parametrize("replacement", [False, True])
def test_multinomial(replacement):
    tpt.seed(2)
    out = T.multinomial(torch.from_numpy(P), 3, replacement=replacement)
    assert out.dtype == torch.int64 and tuple(out.shape) == (2, 3)
    if not replacement:
        assert all(len(set(r)) == 3 for r in out.tolist())
        # row 1 has two non-zero entries: the zeros come last
        assert set(out[1, :2].tolist()) <= {0, 1, 3}
    want = J.multinomial(paddle.to_tensor(P), 3, replacement=replacement)
    assert tuple(want.shape) == (2, 3)


def test_multinomial_accepts_what_torch_refuses():
    """A row with fewer non-zero entries than num_samples, and a row of
    zeros (uniform, as log(max(p, 1e-30)) makes it): the reference and
    the port sample both; torch.multinomial refuses the zeros."""
    p = torch.tensor([[0.0, 0.5, 0.0, 0.5], [0.0, 0.0, 0.0, 0.0]])
    with pytest.raises(RuntimeError, match="sum of probabilities"):
        torch.multinomial(p, 3, replacement=False)
    out = T.multinomial(p, 3)
    assert set(out[0, :2].tolist()) == {1, 3}
    assert all(len(set(r)) == 3 for r in out.tolist())
    want = J.multinomial(paddle.to_tensor(p.numpy()), 3)
    assert all(len(set(r)) == 3 for r in np.asarray(want._data).tolist())


def test_in_place_samplers_on_a_leaf_that_requires_grad():
    for fn in (T.uniform_, T.normal_, T.exponential_):
        w = torch.zeros(32, requires_grad=True)
        assert fn(w) is w
        assert w.requires_grad and w.is_leaf and bool((w != 0).any())
