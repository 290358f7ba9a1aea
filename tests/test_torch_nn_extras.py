"""The rest of the port's ``nn/functional/common.py`` (the dropouts,
``pad``, ``interpolate``, ``unfold`` / ``fold``, ``bilinear``, the
distances and shuffles) with its layers, and ``nn/functional/extras.py``,
against the reference on the CPU from the same numpy inputs: outputs and
the gradients of sum(out * w) for a fixed random w with respect to every
floating input.

``interpolate``'s quirks each have a case: linear downsampling
antialiases (not PyTorch's ``antialias=False``), bicubic is Keys' a = -0.5
(not PyTorch's -0.75), ``align_corners=True`` is linear even for bicubic,
``align_mode`` is read by nothing, ``area`` falls to a nearest take where
the size does not divide, and nearest takes ``floor(i * in / out)`` at
``int(in * scale)`` sizes.  The dropouts draw from a ``torch.Generator``:
only their distribution is held.  Tolerance: f32 values and gradients
1e-5 absolute and relative, unless a test says otherwise."""
import numpy as np
import pytest
import torch
import torch.nn.functional as PF

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.models import load_named_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _run(jfn, tfn, arrays, seed=11, tol=TOL):
    """Both on the numpy ``arrays``: outputs (a tuple's first is the one
    differentiated) and the gradients of every floating input.  Returns
    the port's output."""
    js = [paddle.to_tensor(a, stop_gradient=a.dtype != np.float32)
          for a in arrays]
    ts = [torch.from_numpy(a.copy()).requires_grad_(a.dtype == np.float32)
          for a in arrays]
    oj, ot = jfn(*js), tfn(*ts)
    if isinstance(oj, tuple):
        for j, t in zip(oj[1:], ot[1:]):
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(j._data))
        oj, ot = oj[0], ot[0]
    want = np.asarray(oj._data)
    np.testing.assert_allclose(ot.detach().numpy(), want, **tol,
                               err_msg="output")
    w = _rng(seed).standard_normal(want.shape).astype(np.float32)
    (oj * paddle.to_tensor(w)).sum().backward()
    (ot * torch.from_numpy(w)).sum().backward()
    for i, (j, t) in enumerate(zip(js, ts)):
        if t.requires_grad:     # no path to an input: a zero gradient
            got = t.grad if t.grad is not None else torch.zeros_like(t)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(j.grad._data), **tol,
                err_msg=f"gradient of input {i}")
    return ot


def _x(*shape, seed=0):
    return _rng(seed + len(shape)).standard_normal(shape).astype(np.float32)


def _both(name, *args, **kw):
    return (lambda *t: getattr(JF, name)(*t, *args, **kw),
            lambda *t: getattr(TF, name)(*t, *args, **kw))


# -- pad ----------------------------------------------------------------------

PADS = [
    ((2, 3, 5, 6), [1, 2, 0, 3], "constant", "NCHW"),
    ((2, 3, 5, 6), [1, 2, 3, 1], "reflect", "NCHW"),
    ((2, 3, 5, 6), [2, 1, 1, 3], "replicate", "NCHW"),
    ((2, 3, 5, 6), [4, 2, 1, 7], "circular", "NCHW"),
    ((2, 5, 6, 3), [1, 2, 3, 1], "reflect", "NHWC"),
    ((2, 3, 4), [9, 7], "reflect", "NCL"),           # beyond one reflection
    ((2, 3, 4, 5, 6), [1, 0, 2, 1, 0, 3], "replicate", "NCDHW"),
    ((2, 3, 4), [0, 1, 2, 0, 1, 1], "constant", "NCL"),   # every dim
    ((2, 3, 4), [1, 1, 0, 2, 3, 0], "circular", "NCL"),
]


@pytest.mark.parametrize("case", PADS, ids=lambda c: c[2])
def test_pad_matches_reference(case):
    shape, pads, mode, fmt = case
    _run(*_both("pad", pads, mode=mode, value=0.5, data_format=fmt),
         [_x(*shape)])


def test_zeropad2d_matches_reference():
    _run(*_both("zeropad2d", [1, 0, 2, 3]), [_x(2, 3, 4, 5)])


# -- interpolate --------------------------------------------------------------

INTERP = [
    ((2, 3, 8, 8), dict(size=[4, 4], mode="bilinear")),         # antialias
    ((2, 3, 8, 6), dict(size=[5, 13], mode="bicubic")),         # down + up
    ((2, 3, 5, 7), dict(size=[11, 9], mode="bicubic")),
    ((2, 3, 5, 7), dict(scale_factor=2.5, mode="nearest")),
    ((2, 3, 7, 5), dict(scale_factor=[0.6, 1.7], mode="nearest")),
    ((2, 3, 5, 7), dict(size=[9, 13], mode="bilinear", align_corners=True)),
    ((2, 3, 5, 7), dict(size=[9, 13], mode="bicubic", align_corners=True)),
    ((2, 3, 5, 7), dict(size=[1, 4], mode="bilinear", align_corners=True)),
    ((2, 3, 12, 7), dict(size=[4, 3], mode="area")),             # 3 | 12
    ((2, 5, 7, 3), dict(size=[9, 4], mode="bilinear", data_format="NHWC")),
    ((2, 3, 5, 6, 7), dict(size=[3, 8, 7], mode="trilinear")),
    ((2, 3, 9), dict(size=4, mode="linear", data_format="NCW")),
]


@pytest.mark.parametrize("case", INTERP, ids=range(len(INTERP)))
def test_interpolate_matches_reference(case):
    shape, kw = case
    _run(*_both("interpolate", **kw), [_x(*shape)])


def _interp(x, **kw):
    ref = JF.interpolate(paddle.to_tensor(x), **kw)
    return np.asarray(ref._data), TF.interpolate(torch.from_numpy(x),
                                                 **kw).numpy()


def test_interpolate_quirks_of_the_reference():
    """Each quirk of the reference's interpolate, read off both packages
    beside PyTorch's own F.interpolate."""
    x = _x(2, 3, 8, 8)
    t = torch.from_numpy(x)
    # an 8 -> 4 bilinear resize antialiases: PyTorch's antialias=True
    ref, port = _interp(x, size=[4, 4], mode="bilinear")
    plain = PF.interpolate(t, size=[4, 4], mode="bilinear").numpy()
    aa = PF.interpolate(t, size=[4, 4], mode="bilinear",
                        antialias=True).numpy()
    assert np.abs(ref - plain).max() > 0.1
    np.testing.assert_allclose(ref, aa, atol=1e-6)
    np.testing.assert_allclose(port, ref, **TOL)
    # bicubic upsampling is Keys' a = -0.5, not PyTorch's a = -0.75
    ref, port = _interp(x, size=[16, 16], mode="bicubic")
    cubic75 = PF.interpolate(t, size=[16, 16], mode="bicubic").numpy()
    assert np.abs(ref - cubic75).max() > 0.05
    np.testing.assert_allclose(port, ref, **TOL)
    # align_corners=True is linear for bicubic too; align_mode is not read
    ref_c, port_c = _interp(x, size=[13, 11], mode="bicubic",
                            align_corners=True)
    ref_l, _ = _interp(x, size=[13, 11], mode="bilinear",
                       align_corners=True, align_mode=1)
    np.testing.assert_array_equal(ref_c, ref_l)
    np.testing.assert_allclose(
        port_c, PF.interpolate(t, size=[13, 11], mode="bilinear",
                               align_corners=True).numpy(), **TOL)
    np.testing.assert_allclose(port_c, ref_c, **TOL)
    # area at a size that does not divide is a nearest take
    ref, port = _interp(x, size=[3, 5], mode="area")
    rows, cols = np.floor(np.arange(3) * np.float32(8 / 3)).astype(int), \
        np.floor(np.arange(5) * np.float32(8 / 5)).astype(int)
    np.testing.assert_array_equal(ref, x[:, :, rows][:, :, :, cols])
    np.testing.assert_array_equal(port, ref)
    # nearest: sizes int(in * scale), rows floor(i * in / out)
    ref, port = _interp(_x(1, 1, 7, 7), scale_factor=1.3, mode="nearest")
    assert ref.shape == port.shape == (1, 1, 9, 9)
    np.testing.assert_array_equal(port, ref)


def test_upsample_is_interpolate():
    _run(*_both("upsample", size=[6, 10], mode="bilinear"),
         [_x(2, 3, 4, 5)])


# -- unfold, fold, bilinear, distances, shuffles ------------------------------

FUNCS = [
    ("unfold", [(2, 3, 6, 7)], ([2, 3],), dict(strides=[1, 2],
                                               paddings=1, dilations=1)),
    ("unfold", [(2, 3, 6, 7)], (3,), dict(paddings=[1, 0, 2, 1],
                                          dilations=2)),
    ("unfold", [(2, 3, 6, 7)], (2,), dict(paddings=[1, 2], strides=2)),
    ("fold", [(2, 12, 12)], ([4, 5], 2), dict(strides=1)),
    ("fold", [(2, 12, 16)], ([6, 7], 2), dict(strides=2, paddings=1)),
    ("bilinear", [(4, 3), (4, 5), (6, 3, 5), (6,)], (), {}),
    ("cosine_similarity", [(4, 6, 3), (4, 6, 3)], (), dict(axis=1)),
    ("cosine_similarity", [(4, 6), (4, 6)], (), dict(axis=-1, eps=1e-3)),
    ("pairwise_distance", [(4, 6), (4, 6)], (), {}),
    ("pairwise_distance", [(4, 6), (4, 6)], (), dict(p=3.0, keepdim=True)),
    ("pixel_shuffle", [(2, 12, 3, 4)], (2,), {}),
    ("pixel_unshuffle", [(2, 3, 6, 4)], (2,), {}),
    ("channel_shuffle", [(2, 6, 3, 4)], (3,), {}),
    ("label_smooth", [(4, 5)], (), dict(epsilon=0.2)),
]


@pytest.mark.parametrize("case", FUNCS, ids=lambda c: c[0])
def test_common_functionals_match_reference(case):
    name, shapes, args, kw = case
    _run(*_both(name, *args, **kw),
         [_x(*s, seed=i) for i, s in enumerate(shapes)])


@pytest.mark.parametrize("name", ["pixel_shuffle", "pixel_unshuffle",
                                  "channel_shuffle"])
def test_shuffles_take_nchw_only(name):
    with pytest.raises(NotImplementedError, match="NCHW"):
        getattr(TF, name)(torch.zeros(1, 4, 4, 4), 2, data_format="NHWC")


def test_class_center_sample_raises_in_both():
    with pytest.raises(NotImplementedError):
        JF.class_center_sample(None, 10, 4)
    with pytest.raises(NotImplementedError):
        TF.class_center_sample(None, 10, 4)


# -- dropouts -----------------------------------------------------------------

def test_dropouts_distribution_and_identity():
    """Evaluation mode and p = 0 return the input; dropout2d / 3d drop
    whole channels and scale the rest by 1 / (1 - p); alpha_dropout keeps
    a standard normal's mean and variance (to 1e-2 on 2^20 entries), and a
    seeded generator repeats its draw.  The reference's bits come from
    jax.random; only the distributions match."""
    x = torch.from_numpy(_x(64, 32, 4, 4)) + 3.0
    for fn, fmt in ((TF.dropout2d, "NCHW"), (TF.dropout3d, "NCDHW")):
        xi = x if fn is TF.dropout2d else x[..., None]
        assert fn(xi, 0.5, training=False) is xi
        g = torch.Generator().manual_seed(0)
        out = fn(xi, 0.25, data_format=fmt, generator=g)
        per = out.flatten(2)
        kept = (per != 0).all(-1)
        assert ((per == 0).all(-1) | kept).all()
        assert abs(float(kept.float().mean()) - 0.75) < 0.05
        np.testing.assert_allclose(per[kept].numpy(),
                                   (xi.flatten(2)[kept] / 0.75).numpy(),
                                   rtol=1e-6)
    z = torch.from_numpy(_rng(1).standard_normal(1 << 20).astype(np.float32))
    assert TF.alpha_dropout(z, 0.0) is z
    assert TF.alpha_dropout(z, 0.3, training=False) is z
    outs = [TF.alpha_dropout(z, 0.3, generator=torch.Generator()
                             .manual_seed(5)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert abs(float(outs[0].mean())) < 1e-2
    assert abs(float(outs[0].var()) - 1.0) < 1e-2
    ref = np.asarray(JF.alpha_dropout(paddle.to_tensor(z.numpy()), 0.3)._data)
    assert abs(float(ref.mean())) < 1e-2 and abs(float(ref.var()) - 1) < 1e-2


@pytest.mark.parametrize("name", ["dropout", "dropout2d", "dropout3d",
                                  "Dropout", "Dropout2D", "Dropout3D"])
def test_dropout_p1_keeps_the_graph(name):
    """p = 1 gives zeros on autograd's tape: the input's gradient is zero,
    as through the reference's zeros_like, infinite and NaN entries
    included (their output is 0 too)."""
    x = _x(2, 3, 4, 5, 2) if name.lower().endswith("3d") else _x(2, 3, 4, 5)
    x.reshape(-1)[:2] = [np.inf, np.nan]
    if name[0].isupper():
        fns = (getattr(jnn, name)(1.0), getattr(tnn, name)(1.0))
    else:
        fns = _both(name, 1.0)
    out = _run(*fns, [x])
    assert out.requires_grad and not out.detach().any()


# -- layers -------------------------------------------------------------------

LAYERS = [
    ("Identity", (), {}, [(2, 3)]),
    ("Upsample", (), dict(size=[7, 9], mode="bicubic"), [(2, 3, 4, 5)]),
    ("UpsamplingNearest2D", (), dict(scale_factor=2), [(2, 3, 4, 5)]),
    ("UpsamplingBilinear2D", (), dict(size=[7, 9]), [(2, 3, 4, 5)]),
    ("CosineSimilarity", (), dict(axis=1), [(4, 6), (4, 6)]),
    ("PairwiseDistance", (), dict(p=1.0), [(4, 6), (4, 6)]),
    ("Pad1D", (2,), dict(mode="reflect"), [(2, 3, 5)]),
    ("Pad2D", ([1, 0, 2, 1],), dict(mode="replicate"), [(2, 3, 4, 5)]),
    ("Pad3D", (1,), dict(mode="circular"), [(2, 3, 4, 5, 6)]),
    ("ZeroPad2D", (2,), {}, [(2, 3, 4, 5)]),
    ("Unfold", ([2, 3],), dict(strides=2), [(2, 3, 6, 7)]),
    ("Fold", ([5, 6], 2), {}, [(2, 12, 20)]),
    ("PixelShuffle", (2,), {}, [(2, 8, 3, 4)]),
]


@pytest.mark.parametrize("case", LAYERS, ids=lambda c: c[0])
def test_common_layers_match_reference(case):
    name, args, kw, shapes = case
    _run(getattr(jnn, name)(*args, **kw), getattr(tnn, name)(*args, **kw),
         [_x(*s, seed=i) for i, s in enumerate(shapes)])


def test_bilinear_layer_matches_reference():
    paddle.seed(3)
    jl = jnn.Bilinear(3, 5, 4)
    tl = tnn.Bilinear(3, 5, 4, device="cpu")
    named = {k: np.asarray(p._data) for k, p in jl.named_parameters()}
    assert {k: v.shape for k, v in named.items()} == {
        k: tuple(p.shape) for k, p in tl.named_parameters()}
    load_named_params(tl, named)
    _run(jl, tl, [_x(6, 3), _x(6, 5, seed=1)])


def test_dropout_layers_are_the_identity_in_eval():
    x = torch.ones(2, 3, 4, 4)
    for layer in (tnn.Dropout2D(0.5), tnn.Dropout3D(0.5),
                  tnn.AlphaDropout(0.5)):
        assert layer.eval()(x[..., None] if isinstance(
            layer, tnn.Dropout3D) else x).eq(1).all()


# -- extras ------------------------------------------------------------------

def _grid(n, h, w, seed, spread=1.3):
    return (_rng(seed).uniform(-spread, spread, (n, h, w, 2))
            .astype(np.float32))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("pad", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_reference(mode, pad, align):
    _run(*_both("grid_sample", mode=mode, padding_mode=pad,
                align_corners=align),
         [_x(2, 3, 5, 6), _grid(2, 4, 7, seed=len(mode + pad))])


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_matches_reference(align):
    _run(*_both("affine_grid", [2, 3, 5, 7], align_corners=align),
         [_x(2, 2, 3)])


EXTRAS = [
    ("temporal_shift", [(6, 8, 3, 4)], (3,), dict(shift_ratio=0.25)),
    ("bilinear_tensor_product", [(4, 3), (4, 5), (6, 3, 5), (6,)], (), {}),
    ("diag_embed", [(2, 3, 4)], (), {}),
    ("diag_embed", [(2, 3, 4)], (), dict(offset=2, dim1=0, dim2=2)),
    ("diag_embed", [(3, 4)], (), dict(offset=-1, dim1=-1, dim2=0)),
    ("erf", [(3, 4)], (), {}),
    ("image_resize", [(2, 3, 5, 6)], ([7, 9],), {}),
    ("resize_bilinear", [(2, 3, 8, 6)], ([4, 3],), {}),
    ("resize_nearest", [(2, 3, 5, 6)], ([7, 9],), {}),
    ("smooth_l1", [(4, 5), (4, 5)], (), {}),
    ("pool2d", [(2, 3, 6, 6)], (3, "max", 2, 1), {}),
    ("pool2d", [(2, 3, 6, 6)], (2, "avg", 2), {}),
    ("pool2d", [(2, 3, 6, 6)], (), dict(pool_type="avg",
                                        global_pooling=True)),
]


@pytest.mark.parametrize("case", EXTRAS, ids=lambda c: c[0])
def test_extras_match_reference(case):
    name, shapes, args, kw = case
    _run(*_both(name, *args, **kw),
         [_x(*s, seed=i) for i, s in enumerate(shapes)])


def test_fc_is_linear_with_a_given_weight():
    _run(lambda x, w, b: JF.fc(x, 4, weight=w, bias=b),
         lambda x, w, b: TF.fc(x, 4, weight=w, bias=b),
         [_x(3, 5), _x(5, 4, seed=1), _x(4, seed=2)])
    with pytest.raises(ValueError, match="weight"):
        TF.fc(torch.zeros(3, 5), 4)


def test_warpctc_is_ctc_loss():
    logits = _x(12, 3, 6)
    labels = np.array([[1, 2, 3], [4, 4, 0], [5, 0, 0]], np.int64)
    in_len = np.array([12, 10, 7], np.int64)
    lab_len = np.array([3, 2, 1], np.int64)
    _run(lambda a, b, c, d: JF.warpctc(a, b, c, d, blank=0),
         lambda a, b, c, d: TF.warpctc(a, b, c, d, blank=0),
         [logits, labels, in_len, lab_len])


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_loss_matches_reference(custom):
    r = _rng(4)
    x, w, b = _x(6, 5), _x(6, 5, seed=1), _x(6, seed=2)
    lab = r.integers(0, 7, size=6).astype(np.int64)
    if not custom:
        _run(lambda a, lb, ww, bb: JF.hsigmoid_loss(a, lb, 7, ww, bb),
             lambda a, lb, ww, bb: TF.hsigmoid_loss(a, lb, 7, ww, bb),
             [x, lab, w, b])
        return
    table = r.integers(-1, 6, size=(6, 3)).astype(np.int64)
    code = r.integers(0, 2, size=(6, 3)).astype(np.int64)
    _run(lambda a, lb, ww, bb, t, c: JF.hsigmoid_loss(
             a, lb, 7, ww, bb, path_table=t, path_code=c),
         lambda a, lb, ww, bb, t, c: TF.hsigmoid_loss(
             a, lb, 7, ww, bb, path_table=t, path_code=c),
         [x, lab, w, b, table, code])


def _crf_inputs(b, t, k, seed):
    r = _rng(seed)
    return [r.standard_normal((b, t, k)).astype(np.float32),
            r.standard_normal((k + 2, k)).astype(np.float32),
            r.integers(0, k, size=(b, t)).astype(np.int64),
            np.maximum(r.integers(1, t + 1, size=b), 1).astype(np.int64)]


@pytest.mark.parametrize("lengths", [False, True])
def test_linear_chain_crf_matches_reference(lengths):
    em, tr, lab, lens = _crf_inputs(5, 7, 4, seed=int(lengths))
    if lengths:
        _run(JF.linear_chain_crf, TF.linear_chain_crf, [em, tr, lab, lens])
    else:
        _run(JF.linear_chain_crf, TF.linear_chain_crf, [em, tr, lab])


@pytest.mark.parametrize("tags", [True, False])
@pytest.mark.parametrize("lengths", [False, True])
def test_viterbi_decode_matches_reference(lengths, tags):
    """The scores, their gradients and the paths (held exactly)."""
    em, tr, _, lens = _crf_inputs(5, 7, 4, seed=2 + int(lengths))
    if not tags:
        tr = tr[2:]
    args = [em, tr] + ([lens] if lengths else [])
    out = _run(lambda *a: JF.viterbi_decode(
                   *a, include_start_end_tag=tags),
               lambda *a: TF.viterbi_decode(*a, include_start_end_tag=tags),
               args)
    assert out.shape == (5,)


def test_sequence_conv_matches_reference():
    lens = np.array([5, 2, 4], np.int64)
    _run(lambda x, ln, w, b: JF.sequence_conv(x, ln, w, b, context_length=3),
         lambda x, ln, w, b: TF.sequence_conv(x, ln, w, b, context_length=3),
         [_x(3, 5, 4), lens, _x(12, 6, seed=1), _x(6, seed=2)])


def _alias_args(name):
    """Arguments of each aliased vision op, from a seed."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, generator=g)
    boxes = torch.tensor([[0.5, 1.0, 6.0, 7.5], [2.0, 2.0, 5.0, 4.0]])
    return {
        "roi_align": ((x, boxes, torch.tensor([1, 1]), 2), {}),
        "roi_pool": ((x, boxes, None, 3), {"spatial_scale": 0.5}),
        "yolo_box": ((torch.randn(2, 2 * 7, 4, 4, generator=g),
                      torch.tensor([[32, 32], [32, 40]]), [10, 13, 16, 30],
                      2), {"conf_thresh": 0.2, "downsample_ratio": 8}),
        "prior_box": ((x, torch.zeros(1, 3, 32, 32), [8.0]),
                      {"aspect_ratios": [2.0], "flip": True}),
        "box_coder": ((boxes, torch.full((2, 4), 0.1),
                       torch.randn(2, 4, generator=g)),
                      {"code_type": "decode_center_size"}),
    }[name]


@pytest.mark.parametrize("name", ["roi_align", "roi_pool", "yolo_box",
                                  "prior_box", "box_coder"])
def test_vision_op_aliases_call_vision_ops(name):
    """Each fluid-era alias is vision.ops' function of that name: the
    same outputs, bitwise."""
    from paddle_tpu_torch.vision import ops as tops
    args, kw = _alias_args(name)
    fn = getattr(TF, name)
    assert fn.__name__ == name
    got, want = fn(*args, **kw), getattr(tops, name)(*args, **kw)
    for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        assert torch.equal(a, b)
