"""``Embedding(sparse=True)`` and the eager optimizers' sparse branch
against the reference on the CPU (``framework/selected_rows.py``,
``nn/functional/common.py:77-140``, ``optimizer/optimizer.py:98-131``).

The table's gradient is row-sparse: its merged rows (sorted, repeated
ids summed, a ``padding_idx`` row kept with zero values) equal the
reference's ``SelectedRows.merge()``, and two backward passes add their
rows.  Three eager steps of every optimizer on a table fed repeated ids
and a padding id, beside a dense Linear, leave the parameters and every
state of the reference's (f32, 1e-6; Lars and Lamb 1e-5, their norms sum
in another order), with an optimizer weight decay, a ``ParamAttr``
regulariser and a global-norm clip: SGD and lazy Adam move only the
rows, without decay; non-lazy Adam and AdamW (never lazy) densify
without decay; the rest densify and decay; a clip densifies first.
``TrainStep`` takes the dense path."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu.regularizer as jreg
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
import paddle_tpu_torch.regularizer as treg
from paddle_tpu_torch.framework.selected_rows import SelectedRows
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import load_named_params

V, D, OUT, B, S, PAD, STEPS = 20, 4, 3, 3, 5, 2, 3


def _ids(seed):
    """(B, S) ids from 8 of the 20 rows: repeats, and the padding id."""
    ids = np.random.default_rng(seed).integers(0, 8, (B, S))
    ids[0, :2] = PAD
    ids[1, 1:3] = 5
    return ids.astype(np.int64)


class _Ref(jnn.Layer):
    def __init__(self, reg=None):
        super().__init__()
        self.emb = jnn.Embedding(V, D, padding_idx=PAD, sparse=True,
                                 weight_attr=jnn.ParamAttr(
                                     "emb.w", regularizer=reg))
        self.fc = jnn.Linear(D, OUT, weight_attr=jnn.ParamAttr("fc.w"),
                             bias_attr=jnn.ParamAttr("fc.b"))

    def forward(self, ids):
        return ((self.fc(self.emb(ids)) - 0.5) ** 2).mean()


class _Port(tnn.Layer):
    def __init__(self, reg=None, sparse=True):
        super().__init__()
        self.emb = tnn.Embedding(V, D, padding_idx=PAD, sparse=sparse,
                                 weight_attr=tnn.ParamAttr(
                                     "emb.w", regularizer=reg),
                                 device="cpu")
        self.fc = tnn.Linear(D, OUT, weight_attr=tnn.ParamAttr("fc.w"),
                             bias_attr=tnn.ParamAttr("fc.b"), device="cpu")

    def forward(self, ids):
        return ((self.fc(self.emb(ids)) - 0.5) ** 2).mean()


def _pair(reg=False):
    ref = _Ref(jreg.L2Decay(0.05) if reg else None)
    port = _Port(treg.L2Decay(0.05) if reg else None)
    load_named_params(port, {n: np.array(p._data)
                             for n, p in ref.named_parameters()})
    return ref, port


def test_merged_rows_match_the_reference():
    ref, port = _pair()
    ids = _ids(0)
    ref(paddle.to_tensor(ids)).backward()
    port(torch.from_numpy(ids)).backward()
    g = port.emb.weight.grad
    assert g.is_sparse and g._nnz() == B * S
    want = ref.emb.weight._grad.merge()
    got = SelectedRows.from_grad(g).merge()
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-6, atol=1e-7)
    assert PAD in got.rows.tolist()
    np.testing.assert_array_equal(
        got.values[got.rows.tolist().index(PAD)].numpy(), 0.0)
    np.testing.assert_allclose(port.emb.weight.gradient(),
                               ref.emb.weight.gradient(), rtol=1e-6,
                               atol=1e-7)
    # a second backward adds its rows (the reference concatenates them;
    # PyTorch's sparse sum may combine rows of one id: the merge agrees)
    ref(paddle.to_tensor(_ids(1))).backward()
    port(torch.from_numpy(_ids(1))).backward()
    got = SelectedRows.from_grad(port.emb.weight.grad).merge()
    want = ref.emb.weight._grad.merge()
    assert ref.emb.weight._grad.rows.shape[0] == 2 * B * S
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.emb.weight.gradient(),
                               ref.emb.weight.gradient(), rtol=1e-6,
                               atol=1e-7)
    port.emb.weight.clear_gradient(set_to_zero=True)
    ref.emb.weight.clear_gradient(set_to_zero=True)
    assert not port.emb.weight.grad.is_sparse
    np.testing.assert_array_equal(port.emb.weight.gradient(),
                                  ref.emb.weight.gradient())


def test_selected_rows_arithmetic():
    a = SelectedRows(torch.tensor([3, 1, 3]), torch.ones(3, 2), 5)
    b = SelectedRows(torch.tensor([0]), torch.full((1, 2), 2.0), 5)
    c = (a + b) * 0.5
    assert c.rows.tolist() == [3, 1, 3, 0] and c.shape == [5, 2]
    m = c.merge()
    assert m.rows.tolist() == [0, 1, 3]
    assert m.values[:, 0].tolist() == [1.0, 0.5, 1.0]
    assert torch.equal(c + torch.zeros(5, 2), m.to_dense())
    np.testing.assert_array_equal(c.numpy(), m.to_dense().numpy())


OPTS = {
    "sgd": lambda O, P: O.SGD(0.5, parameters=P, weight_decay=0.1),
    "adam_lazy": lambda O, P: O.Adam(0.05, parameters=P, lazy_mode=True,
                                     weight_decay=0.1),
    "adam": lambda O, P: O.Adam(0.05, parameters=P, weight_decay=0.1),
    "adamw_lazy_mode": lambda O, P: O.AdamW(0.05, parameters=P,
                                            lazy_mode=True),
    "adamw_fused": lambda O, P: O.AdamW(0.05, parameters=P, use_fused=True),
    "momentum": lambda O, P: O.Momentum(0.1, 0.9, parameters=P,
                                        weight_decay=0.1),
    "lars": lambda O, P: O.LarsMomentum(0.1, 0.9, parameters=P),
    "adamax": lambda O, P: O.Adamax(0.05, parameters=P),
    "adagrad": lambda O, P: O.Adagrad(0.1, parameters=P),
    "adadelta": lambda O, P: O.Adadelta(1.0, parameters=P),
    "rmsprop": lambda O, P: O.RMSProp(0.01, parameters=P),
    "lamb": lambda O, P: O.Lamb(0.05, parameters=P),
}


def _state(opt):
    return {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(
        v.detach() if isinstance(v, torch.Tensor) else v))
        for k, v in opt.state_dict().items()}


@pytest.mark.parametrize("variant", ["plain", "regularizer", "clip"])
@pytest.mark.parametrize("name", list(OPTS))
def test_sparse_steps_match_the_reference(name, variant):
    ref, port = _pair(reg=variant == "regularizer")
    jo = OPTS[name](jopt, ref.parameters())
    to = OPTS[name](topt, port.parameters())
    if variant == "clip":
        jo._grad_clip = jnn.ClipGradByGlobalNorm(0.05)
        to._grad_clip = tnn.ClipGradByGlobalNorm(0.05)
    for step in range(STEPS):
        ids = _ids(step)
        ref(paddle.to_tensor(ids)).backward()
        jo.step()
        jo.clear_grad()
        port(torch.from_numpy(ids)).backward()
        assert port.emb.weight.grad.is_sparse
        to.step()
        to.clear_grad()
    tol = dict(rtol=1e-5, atol=1e-5) if name in ("lars", "lamb") else dict(
        rtol=1e-6, atol=1e-6)
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    for n, p in ref.named_parameters():
        np.testing.assert_allclose(got[n], np.asarray(p._data), err_msg=n,
                                   **tol)
    want, have = _state(jo), _state(to)
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(have[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=k, **tol)


def test_lazy_adam_moves_only_the_rows_it_saw():
    ref, port = _pair()
    before = port.emb.weight.detach().clone()
    to = topt.Adam(0.05, parameters=port.parameters(), lazy_mode=True)
    port(torch.from_numpy(_ids(0))).backward()
    to.step()
    seen = set(_ids(0).ravel().tolist()) - {PAD}
    moved = {i for i in range(V)
             if not torch.equal(port.emb.weight[i], before[i])}
    assert moved == seen
    m1 = to._accumulators[id(port.emb.weight)]["moment1"]
    assert set(m1.abs().sum(1).nonzero().ravel().tolist()) == seen


def test_trainstep_takes_the_dense_path():
    """Under TrainStep the reference's sparse path returns None for a
    tracer: the table's gradient is dense, and a step equals the same
    step with sparse=False."""
    ref, port = _pair()
    dense = load_named_params(_Port(sparse=False),
                              {n: p.detach().numpy()
                               for n, p in port.named_parameters()})
    losses = []
    for m in (port, dense):
        step = TrainStep(m, lambda mm, ids: mm(ids), topt.SGD(0.5))
        losses.append(float(step(torch.from_numpy(_ids(0)))))
    assert losses[0] == losses[1]
    for (n, a), b in zip(port.named_parameters(), dense.parameters()):
        assert torch.equal(a, b), n
    assert port.emb.weight.grad is None
