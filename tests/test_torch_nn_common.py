"""The port's small ``nn`` pieces of a seq2seq model against the reference
on the CPU: ``embedding`` / ``Embedding`` (``padding_idx``, a negative one
too), ``one_hot``, ``label_smooth`` (with and without ``prior_dist``),
``softmax`` / ``log_softmax`` (with ``dtype``), ``tanh``, ``sigmoid``,
``softmax_with_cross_entropy``, ``nll_loss``, ``CrossEntropyLoss`` and
``NLLLoss`` (``ignore_index``, ``weight``, every reduction).  Forward
values and the gradient of sum(out * w) in f32, within 1e-6 absolute plus
1e-6 relative (a summed loss near 15 sits a few f32 units apart when the
two packages add in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch.models import load_named_params

ATOL = 1e-6
RTOL = 1e-6
N, C = 6, 7


def _rng(seed):
    return np.random.default_rng(seed)


def _both(jfn, tfn, x, seed=0, cast=None):
    """(reference, port) forward values and the gradients of
    sum(out * w) with respect to x (f32)."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jin, tin = jx, tx
    if cast is not None:
        jin, tin = jx.astype(cast), tx.to(getattr(torch, cast))
    jo, to = jfn(jin), tfn(tin)
    w = _rng(seed + 100).standard_normal(tuple(to.shape)).astype(np.float32)
    (jo.astype("float32") * paddle.to_tensor(w)).sum().backward()
    (to.float() * torch.from_numpy(w)).sum().backward()
    return ((np.asarray(jo.astype("float32")._data),
             np.asarray(jx.grad._data)),
            (to.detach().float().numpy(), tx.grad.numpy()))


def _close(want, got, atol=ATOL):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=RTOL)


@pytest.mark.parametrize("name,kw", [
    ("softmax", {}), ("softmax", {"axis": 0}),
    ("softmax", {"dtype": "float32"}), ("log_softmax", {}),
    ("log_softmax", {"axis": 0}), ("log_softmax", {"dtype": "float32"}),
    ("tanh", {}), ("sigmoid", {})])
def test_activations_match_reference(name, kw):
    x = _rng(1).standard_normal((N, C)).astype(np.float32) * 3
    _close(*_both(lambda a: getattr(jF, name)(a, **kw),
                  lambda a: getattr(tF, name)(a, **kw), x))


@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
def test_softmax_dtype_casts_a_bf16_input_first(name):
    x = _rng(2).standard_normal((N, C)).astype(np.float32) * 3
    want, got = _both(lambda a: getattr(jF, name)(a, dtype="float32"),
                      lambda a: getattr(tF, name)(a, dtype="float32"), x,
                      cast="bfloat16")
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    assert tF.softmax(torch.ones(2, dtype=torch.bfloat16),
                      dtype="float32").dtype == torch.float32
    assert tF.log_softmax(torch.ones(2), dtype=torch.float64
                          ).dtype == torch.float64


@pytest.mark.parametrize("padding_idx", [None, 3, -2])
def test_embedding_matches_reference(padding_idx):
    ref = jnn.Embedding(11, 5, padding_idx=padding_idx)
    port = load_named_params(tnn.Embedding(11, 5, padding_idx=padding_idx,
                                           device="cpu"),
                             {n: np.array(p._data)
                              for n, p in ref.named_parameters()})
    assert [n for n, _ in port.named_parameters()] == ["weight"]
    if padding_idx is not None:
        row = padding_idx % 11
        fresh = tnn.Embedding(11, 5, padding_idx=padding_idx, device="cpu")
        assert port._padding_idx == ref._padding_idx == row
        assert not fresh.weight[row].any()      # zeroed at construction
        with torch.no_grad():                   # and zero when looked up
            port.weight[row] = 1.0
        ref.weight._data = ref.weight._data.at[row].set(1.0)
    ids = _rng(3).integers(0, 11, (4, 9))
    ids[0, :4] = 9                              # -2 of 11
    ids[1, :3] = 3
    jo, to = ref(paddle.to_tensor(ids)), port(torch.from_numpy(ids))
    w = _rng(4).standard_normal((4, 9, 5)).astype(np.float32)
    (jo * paddle.to_tensor(w)).sum().backward()
    (to * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo._data),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               np.asarray(ref.weight.grad._data), atol=ATOL,
                               rtol=0)
    if padding_idx is not None:
        assert not to[ids == padding_idx % 11].any()
        assert not port.weight.grad[padding_idx % 11].any()
    f = tF.embedding(torch.from_numpy(ids).int(), port.weight,
                     padding_idx=port._padding_idx)
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jo._data),
                               atol=ATOL, rtol=0)


def test_sparse_embedding_raises():
    """sparse=True raised until the sparse path was ported; now the layer
    builds, looks up as the dense one does and gives its table a sparse
    gradient, and a table without grad (or not a leaf) takes the dense
    path (test_torch_sparse_embedding.py holds it to the reference)."""
    ids = torch.tensor([[1, 3], [3, 0]])
    sparse = tnn.Embedding(4, 3, padding_idx=0, sparse=True, device="cpu")
    dense = tnn.Embedding(4, 3, padding_idx=0, device="cpu")
    with torch.no_grad():
        dense.weight.copy_(sparse.weight)
    assert torch.equal(sparse(ids), dense(ids))
    sparse(ids).sum().backward()
    assert sparse.weight.grad.is_sparse
    out = tF.embedding(ids, torch.ones(4, 3) * 2, sparse=True)
    assert torch.equal(out, torch.full((2, 2, 3), 2.0))


def test_one_hot_matches_reference():
    ids = _rng(5).integers(0, C, (3, 4))
    ids[0, 0], ids[1, 1] = -1, C                # outside: a zero row
    want = np.asarray(jF.one_hot(paddle.to_tensor(ids), C)._data)
    got = tF.one_hot(torch.from_numpy(ids), C)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 4, C)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tF.one_hot(torch.from_numpy(ids).int(), C).numpy(), want)


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("eps", [0.1, 0.3])
def test_label_smooth_matches_reference(prior, eps):
    lab = _rng(6).random((N, C)).astype(np.float32)
    pd = _rng(7).dirichlet(np.ones(C), (1,)).astype(np.float32)
    if prior:
        jfn = lambda a: jF.label_smooth(a, paddle.to_tensor(pd),
                                        epsilon=eps)
        tfn = lambda a: tF.label_smooth(a, torch.from_numpy(pd),
                                        epsilon=eps)
    else:
        jfn = lambda a: jF.label_smooth(a, epsilon=eps)
        tfn = lambda a: tF.label_smooth(a, epsilon=eps)
    _close(*_both(jfn, tfn, lab))


def _labels(seed, ignore):
    lab = _rng(seed).integers(0, C, (N,))
    if ignore is not None:
        lab[[1, 4]] = ignore
    return lab


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("ignore", [None, 2])
@pytest.mark.parametrize("shape", ["n", "n1"])
def test_softmax_with_cross_entropy_matches_reference(soft, ignore, shape):
    x = _rng(8).standard_normal((N, C)).astype(np.float32)
    if soft:
        lab = _rng(9).dirichlet(np.ones(C), N).astype(np.float32)
        jl, tl = paddle.to_tensor(lab), torch.from_numpy(lab)
    else:
        lab = _labels(9, ignore)
        lab = lab[:, None] if shape == "n1" else lab
        jl, tl = paddle.to_tensor(lab), torch.from_numpy(lab)
    kw = {} if ignore is None else {"ignore_index": ignore}
    want, got = _both(
        lambda a: jF.softmax_with_cross_entropy(a, jl, soft_label=soft, **kw),
        lambda a: tF.softmax_with_cross_entropy(a, tl, soft_label=soft, **kw),
        x)
    assert got[0].shape == (N, 1)
    _close(want, got)
    loss, sm = tF.softmax_with_cross_entropy(torch.from_numpy(x), tl,
                                             soft_label=soft,
                                             return_softmax=True)
    np.testing.assert_allclose(sm.numpy(), np.asarray(
        jF.softmax(paddle.to_tensor(x))._data), atol=ATOL, rtol=0)


def _loss_case(kind, weighted, ignore, reduction):
    """(reference fn, port fn) of x for a loss layer or functional."""
    wt = _rng(10).random(C).astype(np.float32) + 0.5
    jw = paddle.to_tensor(wt) if weighted else None
    tw = torch.from_numpy(wt) if weighted else None
    lab = _labels(11, ignore)
    kw = {"reduction": reduction}
    if ignore is not None:
        kw["ignore_index"] = ignore
    jl, tl = paddle.to_tensor(lab), torch.from_numpy(lab)
    if kind == "CrossEntropyLoss":
        j, t = jnn.CrossEntropyLoss(jw, **kw), tnn.CrossEntropyLoss(tw, **kw)
        return (lambda a: j(a, jl)), (lambda a: t(a, tl))
    if kind == "NLLLoss":
        j, t = jnn.NLLLoss(jw, **kw), tnn.NLLLoss(tw, **kw)
        return (lambda a: j(jF.log_softmax(a), jl)), (
            lambda a: t(tF.log_softmax(a), tl))
    return (lambda a: jF.nll_loss(jF.log_softmax(a), jl, jw, **kw)), (
        lambda a: tF.nll_loss(tF.log_softmax(a), tl, tw, **kw))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore", [None, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["CrossEntropyLoss", "NLLLoss",
                                  "nll_loss"])
def test_losses_match_reference(kind, weighted, ignore, reduction):
    x = _rng(12).standard_normal((N, C)).astype(np.float32)
    jfn, tfn = _loss_case(kind, weighted, ignore, reduction)
    _close(*_both(jfn, tfn, x))


def test_loss_layers_hold_no_parameters():
    w = torch.ones(C)
    assert not list(tnn.CrossEntropyLoss(w).parameters())
    assert not list(tnn.NLLLoss(w).parameters())
