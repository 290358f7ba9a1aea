"""The port's tensor/sequence.py against the reference on the CPU
(torch_tensor_common's tolerances; index and length outputs bitwise).

The inputs hold the trouble spots: a zero-length row among the padded
lengths, an empty segment and segment ids outside ``[0, num_segments)``
among the flat ones, planted ties in every max and min (the gradient
splits evenly among them, where ``torch.max(dim=...)`` gives it to one),
a ``padding_idx`` among the ids, and one row of ``embedding_bag``'s max
masked out entirely.  ``nn.functional``'s sequence names are the same
objects as ``tensor.sequence``'s."""
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu.tensor.sequence as JS
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.tensor as T
import paddle_tpu_torch.tensor.sequence as TS

from torch_tensor_common import BF16, assert_same, check, rng, run

R = rng(30)
LENS = np.array([3, 0, 6, 2], np.int64)
PADDED = R.standard_normal((4, 6, 3)).astype(np.float32)
PADDED[0, 0] = PADDED[0, 2]                 # a tie in row 0's max and min
PADDED[2, 1, 0] = PADDED[2, 4, 0] = 9.0     # a tied max
FLAT = R.standard_normal((11, 3)).astype(np.float32)
FLAT[4] = FLAT[2]                           # tie within segment 2
SEG = np.array([0, 0, 2, 2, 2, 3, 3, 3, 3, 7, -1], np.int64)  # 1 empty
IDS = np.array([[1, 4, 0, 4, 2, 3], [0, 0, 0, 0, 0, 0], [5, 6, 7, 2, 2, 1],
                [0, 6, 3, 3, 3, 1]], np.int64)
TABLE = R.standard_normal((8, 5)).astype(np.float32)


def _fns(name):
    return getattr(JS, name), getattr(TS, name)


def _check(name, args, kwargs=None, grad=(), tol=None):
    ref, port = _fns(name)
    return check(name, args, kwargs, grad=grad, ref_fn=ref, port_fn=port,
                 tol=tol)


def test_functional_names_are_the_same_objects():
    names = ["embedding_bag", "segment_softmax", "sequence_mask",
             "sequence_pad", "sequence_unpad", "sequence_pool",
             "sequence_softmax", "sequence_reverse", "sequence_concat",
             "sequence_enumerate", "sequence_expand_as",
             "sequence_first_step", "sequence_last_step"]
    for n in names:
        assert getattr(TF, n) is getattr(TS, n) is getattr(T, n), n
        assert getattr(JF, n) is getattr(JS, n), n


@pytest.mark.parametrize("maxlen,dtype", [(None, "int64"), (4, "bool")])
def test_sequence_mask(maxlen, dtype):
    _check("sequence_mask", [LENS], {"maxlen": maxlen, "dtype": dtype})


def test_lengths_and_segment_ids():
    _check("lengths_to_segment_ids", [LENS])
    _check("segment_ids_to_lengths", [SEG, 5])


@pytest.mark.parametrize("maxlen,dtype", [(None, "float32"),
                                          (4, "bfloat16")])
def test_sequence_pad_and_unpad(maxlen, dtype):
    vals = FLAT if dtype == "float32" else BF16(FLAT)
    got, want = _check("sequence_pad", [vals, -1.0, LENS[[0, 2, 3]]],
                       {"maxlen": maxlen},
                       grad=(0,) if dtype == "float32" else ())
    if maxlen is None:
        back = TS.sequence_unpad(got[0], torch.from_numpy(LENS[[0, 2, 3]]))
        assert torch.equal(back.detach(), (torch.from_numpy(FLAT) if dtype
                                           == "float32" else torch.from_numpy(
                                               FLAT).to(torch.bfloat16)))
    _check("sequence_unpad", [PADDED if dtype == "float32"
                              else BF16(PADDED), LENS],
           grad=(0,) if dtype == "float32" else ())


@pytest.mark.parametrize("name,dtype", [
    ("segment_sum", "float32"), ("segment_mean", "float32"),
    ("segment_max", "float32"), ("segment_min", "float32"),
    ("segment_softmax", "float32"), ("segment_sum", "bfloat16"),
    ("segment_max", "bfloat16")])
def test_segment_reductions_empty_and_dropped(name, dtype):
    vals = FLAT if dtype == "float32" else BF16(FLAT)
    got, want = _check(name, [vals, SEG, 5],
                       grad=(0,) if dtype == "float32" else ())
    if name in ("segment_max", "segment_min"):
        assert got[0][1].abs().sum() == 0          # the empty segment


@pytest.mark.parametrize("name", ["segment_max"])
def test_segment_reductions_infer_the_count(name):
    _check(name, [FLAT[:9], SEG[:9]])


def test_segment_mean_of_integers_is_float64():
    _check("segment_mean", [(FLAT * 3).astype(np.int32), SEG, 5])


def test_segment_softmax_non_finite_max():
    vals = np.array([-np.inf, -np.inf, 1.0, np.inf, 2.0], np.float32)
    _check("segment_softmax", [vals, np.array([0, 0, 1, 2, 2])])


POOLS = ["average", "sum", "sqrt", "max", "min", "first", "last"]


@pytest.mark.parametrize("pool", POOLS)
def test_sequence_pool(pool):
    _check("sequence_pool", [PADDED, pool, LENS],
           grad=(0,) if pool in ("average", "max", "min", "last") else ())


@pytest.mark.parametrize("pool", ["max"])
def test_sequence_pool_pad_value_bf16(pool):
    _check("sequence_pool", [BF16(PADDED), pool, LENS], {"pad_value": 2.5})


def test_sequence_first_last_step():
    _check("sequence_first_step", [PADDED, LENS])
    _check("sequence_last_step", [PADDED, LENS])


def test_max_pool_tie_gradient_is_not_torch_max():
    """The planted ties: torch.max(dim)'s gradient goes to one element,
    the reference's and the port's split it."""
    x = torch.from_numpy(PADDED.copy()).requires_grad_()
    TS.sequence_pool(x, "max", torch.from_numpy(LENS)).sum().backward()
    naive = torch.from_numpy(PADDED.copy()).requires_grad_()
    mask = (torch.arange(6)[None, :] < torch.from_numpy(LENS)[:, None])
    torch.where(mask[..., None], naive, -torch.inf).max(dim=1).values[
        [0, 2, 3]].sum().backward()
    assert float(x.grad[2, 1, 0]) == float(x.grad[2, 4, 0]) == 0.5
    assert not torch.equal(naive.grad, x.grad)


def test_sequence_softmax():
    _check("sequence_softmax", [PADDED[..., 0].copy(), LENS], grad=(0,))


@pytest.mark.parametrize("dtype", ["float32"])
def test_sequence_reverse(dtype):
    _check("sequence_reverse", [PADDED if dtype == "float32"
                                else BF16(PADDED), LENS],
           grad=(0,) if dtype == "float32" else ())


def test_sequence_concat():
    other = R.standard_normal((4, 3, 3)).astype(np.float32)
    _check("sequence_concat", [[PADDED, other],
                               [LENS, np.array([1, 3, 0, 2])]])
    xs = [torch.from_numpy(PADDED.copy()).requires_grad_(),
          torch.from_numpy(other.copy()).requires_grad_()]
    out, _ = TS.sequence_concat(xs, [torch.from_numpy(LENS),
                                     torch.tensor([1, 3, 0, 2])])
    out.sum().backward()
    assert torch.equal(xs[1].grad[:, :, 0], torch.tensor(
        [[1.0, 0, 0], [1, 1, 1], [0, 0, 0], [1, 1, 0]]))


def test_sequence_expand_as():
    _check("sequence_expand_as", [PADDED[:, 0].copy(), LENS], grad=(0,))


@pytest.mark.parametrize("lengths", [LENS])
def test_sequence_enumerate(lengths):
    args = [IDS, 3]
    kw = {"pad_value": -1}
    if lengths is not None:
        kw["lengths"] = lengths
    _check("sequence_enumerate", args, kw)


@pytest.mark.parametrize("mode,padding_idx", [("sum", 0), ("mean", 0),
                                              ("max", 0), ("max", None)])
def test_embedding_bag_padded(mode, padding_idx):
    _check("embedding_bag", [IDS, TABLE, LENS],
           {"mode": mode, "padding_idx": padding_idx},
           grad=(1,) if padding_idx == 0 else ())


def test_embedding_bag_gradient_reaches_only_the_ids_read():
    w = torch.from_numpy(TABLE.copy()).requires_grad_()
    TS.embedding_bag(torch.from_numpy(IDS), w, torch.from_numpy(LENS),
                     mode="sum").sum().backward()
    read = {1, 4, 0, 5, 6, 7, 2}
    for i in range(8):
        assert bool(w.grad[i].abs().sum() > 0) == (i in read), i


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_embedding_bag_flat(mode):
    ids = IDS.reshape(-1)[:11]
    _check("embedding_bag", [ids, TABLE, np.clip(SEG, 0, 3)],
           {"mode": mode}, grad=(1,) if mode == "max" else ())


def test_embedding_bag_mean_is_pooled_lookup():
    e = T.gather(torch.from_numpy(TABLE), torch.from_numpy(IDS), axis=0)
    pooled = TS.sequence_pool(e, "average", torch.from_numpy(LENS))
    bag = TS.embedding_bag(torch.from_numpy(IDS), torch.from_numpy(TABLE),
                           torch.from_numpy(LENS), mode="mean")
    torch.testing.assert_close(bag, pooled, rtol=1e-6, atol=1e-6)


def test_embedding_bag_out_of_range_id_is_nan():
    got, want = run("embedding_bag", [np.array([[1, 9]]), TABLE],
                    ref_fn=JS.embedding_bag)
    assert_same(got, want)
    assert torch.isnan(got).all()
