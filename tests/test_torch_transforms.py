"""The port's ``vision.transforms`` against the reference's on the same
numpy images: every functional form and every transform class, held
bitwise (both are numpy on the host).

``resize`` of a uint8 image takes PIL's ``Image.resize`` where PIL
imports and its own numpy bilinear / nearest where it does not; both
routes are held, the numpy one with PIL hidden from both packages
(``sys.modules["PIL"] = None``).  The random transforms are held draw for
draw: the reference seeded by ``random.seed(s)``, the port given
``random.Random(s)`` (and, with no generator, the global ``random``
seeded alike)."""
import random
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.vision.transforms as J
import paddle_tpu_torch.vision.transforms as T


def _img(h=37, w=45, c=3, seed=0, dtype=np.uint8):
    r = np.random.default_rng(seed)
    if dtype == np.uint8:
        return r.integers(0, 256, (h, w, c), dtype=np.uint8)
    return r.random((h, w, c)).astype(dtype)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(getattr(want, "_data", want))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


FUNCS = [
    ("to_tensor", (), {}),
    ("to_tensor", (), dict(data_format="HWC")),
    ("resize", ([20, 31],), {}),
    ("resize", (24,), {}),
    ("resize", ([50, 40],), dict(interpolation="nearest")),
    ("hflip", (), {}),
    ("vflip", (), {}),
    ("crop", (3, 5, 20, 17), {}),
    ("center_crop", (21,), {}),
    ("center_crop", ([30, 50],), {}),
    ("pad", (3,), dict(fill=7)),
    ("pad", ([2, 5],), dict(padding_mode="reflect")),
    ("pad", ([1, 2, 3, 4],), dict(padding_mode="edge")),
    ("pad", (2,), dict(padding_mode="symmetric")),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("case", FUNCS, ids=lambda c: c[0])
def test_functional_matches_reference(case, dtype):
    name, args, kw = case
    img = _img(dtype=dtype)
    _eq(getattr(T, name)(img, *args, **kw), getattr(J, name)(img, *args,
                                                             **kw))


def test_to_tensor_and_normalize_stay_on_the_host():
    """``out="tensor"`` gives a CPU torch tensor; normalize returns what
    it was given, array or tensor."""
    img = _img()
    out = T.to_tensor(img, out="tensor")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    _eq(out, J.to_tensor(img, out="tensor"))
    chw = T.to_tensor(img)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    _eq(T.normalize(chw, mean, std), J.normalize(chw, mean, std))
    got = T.normalize(torch.from_numpy(chw), mean, std)
    assert isinstance(got, torch.Tensor)
    _eq(got, J.normalize(chw, mean, std))
    hwc = img.astype(np.float32)
    _eq(T.normalize(hwc, 3.0, 2.0, data_format="HWC"),
        J.normalize(hwc, [3.0] * 3, [2.0] * 3, data_format="HWC"))
    _eq(T.Normalize(3.0, 2.0, data_format="HWC")(hwc),
        J.Normalize(3.0, 2.0, data_format="HWC")(hwc))


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_uint8_both_routes(interp, channels, monkeypatch):
    """PIL's route while PIL imports, the numpy route once it is hidden
    from both packages; the two routes give different images."""
    img = _img(c=channels, seed=channels)
    assert T.resize_route() == "PIL"
    via_pil = T.resize(img, [23, 61], interp)
    _eq(via_pil, J.resize(img, [23, 61], interp))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert T.resize_route() == "numpy"
    via_np = T.resize(img, [23, 61], interp)
    _eq(via_np, J.resize(img, [23, 61], interp))
    if interp == "bilinear":
        assert not np.array_equal(via_np, via_pil)


def _draws(make_j, make_t, img, calls=6, seed=3):
    """The reference seeded by random.seed, the port by its own
    random.Random and by the global random: every output equal."""
    random.seed(seed)
    jt = make_j()
    want = [np.array(jt(img)) for _ in range(calls)]
    tt = make_t(random.Random(seed))
    for w in want:
        _eq(np.array(tt(img)), w)
    random.seed(seed)
    tt = make_t(None)
    for w in want:
        _eq(np.array(tt(img)), w)
    return want


RANDOM = [
    ("RandomHorizontalFlip", (), {}),
    ("RandomVerticalFlip", (), dict(prob=0.3)),
    ("RandomCrop", (20,), {}),
    ("RandomCrop", ([40, 50],), dict(padding=4, pad_if_needed=True,
                                     padding_mode="reflect")),
    ("RandomResizedCrop", (24,), {}),
    ("RandomResizedCrop", ([16, 20],), dict(scale=(0.5, 1.0),
                                            interpolation="nearest")),
    ("BrightnessTransform", (0.4,), {}),
    ("ContrastTransform", (0.4,), {}),
    ("SaturationTransform", (0.4,), {}),
    ("HueTransform", (0.2,), {}),
    ("ColorJitter", (0.4, 0.4, 0.4, 0.1), {}),
    ("RandomRotation", (270,), {}),
    ("RandomRotation", ((-100, 45),), {}),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("case", RANDOM, ids=lambda c: c[0])
def test_random_transforms_draw_for_draw(case, dtype):
    name, args, kw = case
    _draws(lambda: getattr(J, name)(*args, **kw),
           lambda g: getattr(T, name)(*args, generator=g, **kw),
           _img(dtype=dtype))


DETERMINISTIC = [
    ("Resize", ([30, 20],), {}),
    ("CenterCrop", (16,), {}),
    ("Pad", ([1, 2],), dict(fill=3)),
    ("Transpose", (), {}),
    ("Grayscale", (), {}),
    ("Grayscale", (3,), {}),
    ("ToTensor", (), {}),
]


@pytest.mark.parametrize("case", DETERMINISTIC, ids=lambda c: c[0])
def test_transform_classes_match_reference(case):
    name, args, kw = case
    img = _img()
    _eq(getattr(T, name)(*args, **kw)(img), getattr(J, name)(*args, **kw)(
        img))


def test_training_recipe_draw_for_draw():
    """bench.py's file-fed recipe, RandomResizedCrop(224) then a flip, on
    256 x 256 images: the same crops and flips image after image."""
    imgs = [_img(256, 256, seed=s) for s in range(4)]

    def run(make):
        return [np.array(make(im)) for im in imgs]
    random.seed(0)
    want = run(J.Compose([J.RandomResizedCrop(224),
                          J.RandomHorizontalFlip()]))
    g = random.Random(0)
    got = run(T.Compose([T.RandomResizedCrop(224, generator=g),
                         T.RandomHorizontalFlip(generator=g)]))
    for a, b in zip(got, want):
        _eq(a, b)
