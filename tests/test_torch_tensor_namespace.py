"""The port's tensor namespace against the reference's: every name of the
``__all__`` of ``creation``, ``math``, ``linalg``, ``logic``,
``manipulation``, ``random``, ``search``, ``sequence`` and ``stat``
resolves in ``paddle_tpu_torch.tensor`` and at the top level, each to the
module the reference's precedence picks (``mean`` to ``stat``, ``mode``
to ``search``, ``numel`` to ``creation``, ``index_select`` to
``search``); every flat ``paddle_tpu.tensor.<name>`` of API.spec
resolves but the reference's tape internals ``apply`` / ``apply1``;
``nn.functional``'s sequence names are ``tensor.sequence``'s objects;
the top-level names this port fills exist; ``torch.Tensor`` is not
patched; ``einsum``, ``histogramdd``, ``add_n`` and ``sum_arrays`` match
the reference (torch_tensor_common's tolerances).

Last, GPT-2's evaluation as chip_smoke.py's phase 37 composes it, on a
gpt_tiny model's logits (B=2, S=32, V=256) with ties planted by rounding
a third of the rows to a grid of 1/8: the next-token NLL through
``logsumexp`` and ``index_sample``, perplexity, ``accuracy`` at k=1 and
5, ``argmax`` agreement, ``topk(40)``, the nucleus cut at p = 0.9
(``argsort(descending=True)``, ``cumsum``, ``searchsorted`` row by row)
and the magnitude quantiles of the parameters, in both packages on the
same logits: every index bitwise."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch
import paddle_tpu_torch.tensor as T
from paddle_tpu.tensor import (creation, linalg, logic, manipulation, math,
                               random, search, sequence, stat)
from paddle_tpu_torch.models import GPT, gpt_tiny

from torch_tensor_common import BF16, assert_same, check, port_np, rng

MODULES = {"creation": creation, "math": math, "linalg": linalg,
           "logic": logic, "manipulation": manipulation, "random": random,
           "search": search, "sequence": sequence, "stat": stat}
NAMES = sorted({n for m in MODULES.values() for n in m.__all__})
# the reference's own tape (core.py): torch's autograd takes their place
NOT_PORTED = {"apply": "records an op on the reference's eager tape",
              "apply1": "records an op on the reference's eager tape"}


def _owner(namespace, name, modules):
    obj = getattr(namespace, name)
    return [k for k, m in modules.items() if getattr(m, name, None) is obj]


@pytest.mark.parametrize("module", sorted(MODULES))
def test_every_name_of_the_module_is_ported(module):
    port_mod = getattr(T, module)
    missing = [n for n in MODULES[module].__all__
               if not hasattr(port_mod, n)]
    assert not missing, f"{module}: {missing}"
    assert sorted(port_mod.__all__) == sorted(MODULES[module].__all__)


def test_the_namespace_resolves_as_the_reference_does():
    assert len(NAMES) == 273
    port_modules = {k: getattr(T, k) for k in MODULES}
    for name in NAMES:
        want = _owner(J, name, MODULES)
        got = _owner(T, name, port_modules)
        assert want and got[:1] == want[:1] or set(got) >= set(want), \
            f"{name}: reference {want}, port {got}"
        assert getattr(paddle_tpu_torch, name) is getattr(T, name), name
    assert T.mean is T.stat.mean and T.mean is not T.math.mean
    assert T.mode is T.search.mode
    assert T.numel is T.creation.numel
    assert T.index_select is T.search.index_select
    assert T.index_sample is T.search.index_sample
    assert T.one_hot is T.manipulation.one_hot
    for name in ("einsum", "histogramdd", "add_n", "sum_arrays"):
        assert callable(getattr(T, name))
    assert paddle_tpu_torch.add_n is T.add_n
    assert paddle_tpu_torch.einsum is T.einsum


def test_every_flat_api_spec_name_resolves():
    spec = (Path(__file__).resolve().parents[1] / "API.spec").read_text()
    names = set(re.findall(r"^paddle_tpu\.tensor\.(\w+) ", spec, re.M))
    assert len(names) == 282
    missing = sorted(n for n in names if not hasattr(T, n))
    assert missing == sorted(NOT_PORTED), missing
    assert T.Tensor is torch.Tensor
    assert T.convert_dtype("bf16") == torch.bfloat16


def test_functional_sequence_names_are_the_tensor_library_s():
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    names = [n for n in sequence.__all__ if hasattr(JF, n)]
    assert len(names) == 13
    for n in names:
        assert getattr(TF, n) is getattr(T.sequence, n), n
    assert TF.one_hot is T.one_hot and TF.pad is T.pad


TOP_LEVEL = (
    "float16 bfloat16 float32 float64 int8 uint8 int16 int32 int64 bool "
    "complex64 complex128 autograd grad no_grad enable_grad "
    "is_grad_enabled set_grad_enabled set_grad_enabled_ seed get_rng_state "
    "set_rng_state default_generator Generator get_cuda_rng_state "
    "set_cuda_rng_state save load get_default_dtype set_default_dtype "
    "convert_dtype get_flags set_flags Tensor Parameter LoDTensor VarBase "
    "LoDTensorArray elementwise_add elementwise_sub elementwise_div "
    "elementwise_floordiv elementwise_mod elementwise_pow reduce_sum "
    "reduce_mean reduce_max reduce_min reduce_prod crop_tensor "
    "fill_constant broadcast_shape rank shape has_nan has_inf "
    "create_global_var get_tensor_from_selected_rows tanh_ scatter_ "
    "in_dynamic_mode in_dygraph_mode disable_signal_handler "
    "set_printoptions device_count commit full_version CPUPlace CUDAPlace "
    "CUDAPinnedPlace is_compiled_with_cuda is_compiled_with_xpu "
    "is_compiled_with_tpu get_cudnn_version optimizer jit vision models "
    "parallel nn framework static inference quantization creation math "
    "linalg logic manipulation random search sequence stat distributed "
    "DataParallel enable_static disable_static enable_dygraph "
    "disable_dygraph data VarDesc monitor profiler").split()
# what the reference's paddle_tpu.framework re-exports (:15-30)
FRAMEWORK = ("save load seed Generator default_generator get_rng_state "
             "set_rng_state Parameter Tensor no_grad CPUPlace CUDAPlace "
             "get_default_dtype set_default_dtype in_dygraph_mode").split()


def test_top_level_names():
    missing = [n for n in TOP_LEVEL if not hasattr(paddle_tpu_torch, n)]
    assert not missing, missing
    assert all(hasattr(paddle, n) for n in TOP_LEVEL)
    for n in ("TPUPlace", "XPUPlace"):
        assert hasattr(paddle, n) and not hasattr(paddle_tpu_torch, n), n
    assert paddle_tpu_torch.float32 is torch.float32
    assert paddle_tpu_torch.seed is T.random.seed


def test_static_switches_data_and_vardesc_as_the_reference():
    """enable_/disable_static and enable_/disable_dygraph flip the mode as
    the reference's do, data is an InputSpec, VarDesc names the dtypes;
    monitor and profiler are the planes, and framework binds monitor,
    chaos and observability with locks and health as submodules."""
    for mod in (paddle, paddle_tpu_torch):
        mod.enable_static()
        try:
            assert not mod.in_dynamic_mode()
            mod.enable_dygraph()
            assert mod.in_dynamic_mode()
            mod.disable_dygraph()
            assert not mod.in_dynamic_mode()
        finally:
            mod.disable_static()
        assert mod.in_dynamic_mode()
    want = paddle.data("x", [None, 4], "int64")
    got = paddle_tpu_torch.data("x", [None, 4], "int64")
    assert type(got).__name__ == type(want).__name__ == "InputSpec"
    assert (got.name, list(got.shape)) == (want.name, list(want.shape))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    for n in ("FP16", "BF16", "FP32", "FP64", "INT8", "UINT8", "INT16",
              "INT32", "INT64", "BOOL", "COMPLEX64", "COMPLEX128"):
        assert str(getattr(paddle_tpu_torch.VarDesc.VarType, n)).replace(
            "torch.", "").replace("bool", "bool_") == str(
            getattr(paddle.VarDesc.VarType, n)).replace("bool", "bool_"), n
    import paddle_tpu_torch.framework.health as th
    import paddle_tpu_torch.framework.locks as tl
    assert paddle_tpu_torch.monitor.__name__ == \
        "paddle_tpu_torch.framework.monitor"
    assert paddle_tpu_torch.profiler.__name__ == "paddle_tpu_torch.profiler"
    for n in ("monitor", "chaos", "observability"):
        assert getattr(paddle_tpu_torch.framework, n).__name__ == \
            f"paddle_tpu_torch.framework.{n}"
        assert hasattr(paddle.framework, n)
    assert paddle_tpu_torch.framework.locks is tl
    assert paddle_tpu_torch.framework.health is th


def test_subpackages_resolve_after_the_top_level_import_alone():
    """A fresh process that imports only the top level reaches the
    subpackages' names, and the framework's re-exports are the top
    level's objects."""
    import subprocess
    import sys
    code = ("import paddle_tpu_torch as paddle\n"
            "print(paddle.optimizer.AdamW.__name__, "
            "paddle.linalg.norm.__name__, paddle.jit.to_static.__name__, "
            "paddle.static.InputSpec.__name__, "
            "paddle.inference.Config.__name__, "
            "paddle.quantization.convert_to_int8_inference.__name__, "
            "paddle.vision.models.resnet18.__name__, "
            "paddle.models.GPT.__name__, "
            "paddle.distributed.init_parallel_env.__name__, "
            "paddle.distributed.fleet.DistributedStrategy.__name__)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["AdamW", "norm", "to_static", "InputSpec",
                                  "Config", "convert_to_int8_inference",
                                  "resnet18", "GPT", "init_parallel_env",
                                  "DistributedStrategy"]
    for n in FRAMEWORK:
        assert hasattr(paddle.framework, n), n
        assert getattr(paddle_tpu_torch.framework, n) is \
            getattr(paddle_tpu_torch, n), n
    paddle_tpu_torch.static.enable_static()
    try:
        assert not paddle_tpu_torch.framework.in_dygraph_mode()
    finally:
        paddle_tpu_torch.static.disable_static()


def test_torch_tensor_is_not_patched():
    """No attribute of torch.Tensor comes from the port."""
    for cls in (torch.Tensor, torch._C.TensorBase):
        ours = [k for k, v in vars(cls).items()
                if str(getattr(v, "__module__", "")).startswith(
                    "paddle_tpu_torch")]
        assert not ours, ours
    assert torch.Tensor.__eq__ is torch._C.TensorBase.__eq__


@pytest.mark.parametrize("eq,shapes", [("ii->", [(4, 4)]),
                                       ("bij,bjk->bik", [(2, 3, 4),
                                                         (2, 4, 5)]),
                                       ("i,j->ij", [(3,), (4,)])])
def test_einsum(eq, shapes):
    r = rng(1)
    args = [r.standard_normal(s).astype(np.float32) for s in shapes]
    check("einsum", [eq] + args,
          grad=tuple(range(1, len(args) + 1)) if eq[0] == "b" else ())


def test_einsum_promotes():
    r = rng(2)
    check("einsum", ["ij,jk->ik", (r.standard_normal((2, 3)) * 3)
                     .astype(np.int32), r.standard_normal((3, 2))
                     .astype(np.float32)])


@pytest.mark.parametrize("case", ["ranges", "weights"])
def test_histogramdd(case):
    """Per-dimension counts and a range, as a density; weights over
    explicit edges."""
    x = rng(3).standard_normal((50, 2)).astype(np.float32)
    edges = np.array([-2.0, 0.0, 0.5, 2.0], np.float32)
    w = rng(4).random(50).astype(np.float32)
    kw = {"bins": [3, 5], "ranges": [(-1.0, 1.0), None], "density": True}
    if case == "weights":
        got = T.histogramdd(torch.from_numpy(x),
                            bins=[torch.from_numpy(edges), 3],
                            weights=torch.from_numpy(w))
        want = J.histogramdd(paddle.to_tensor(x), bins=[edges, 3],
                             weights=paddle.to_tensor(w))
    else:
        got = T.histogramdd(torch.from_numpy(x), **kw)
        want = J.histogramdd(paddle.to_tensor(x), **kw)
    assert_same(got[0], want[0], "counts")
    assert len(got[1]) == len(want[1]) == 2
    for g, w_ in zip(got[1], want[1]):
        assert_same(g, w_, "edges")


@pytest.mark.parametrize("case", ["list", "mixed", "bf16", "single"])
def test_add_n(case):
    r = rng(5)
    xs = [r.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    if case == "single":
        t = torch.from_numpy(xs[0])
        assert T.add_n(t) is t
        return
    if case == "mixed":
        xs[1] = xs[1].astype(np.float64)
    elif case == "bf16":
        xs = [BF16(v) for v in xs]
    got = T.add_n([torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
                   else torch.from_numpy(v.arr).to(torch.bfloat16)
                   for v in xs])
    want = J.add_n([paddle.to_tensor(v) if isinstance(v, np.ndarray)
                    else paddle.to_tensor(v.arr).astype("bfloat16")
                    for v in xs])
    assert_same(got, want)
    assert_same(T.sum_arrays([got, got]), J.sum_arrays([want, want]))


# -- GPT-2's evaluation, as phase 37 composes it ---------------------------

def _gpt_tiny_eval_inputs():
    cfg = gpt_tiny(num_layers=2)
    model = GPT(cfg, device="cpu")
    ids = rng(6).integers(0, cfg.vocab_size, (2, 32))
    with torch.no_grad():
        logits = model(ids)[:, :-1].reshape(-1, cfg.vocab_size).numpy()
    logits = logits.copy()
    logits[::3] = np.round(logits[::3] * 8) / 8      # planted ties
    labels = ids[:, 1:].reshape(-1, 1).astype(np.int64)
    params = np.concatenate([p.detach().numpy().ravel()
                             for p in model.parameters()])
    return logits.astype(np.float32), labels, np.abs(params)


def _eval(ns, to, logits, labels, params):
    """Phase 37's calls through one package's namespace ``ns``; ``to``
    makes its tensors."""
    lg, lab = to(logits), to(labels)
    lse = ns.logsumexp(lg, axis=-1)
    gold = ns.index_sample(lg, lab)[:, 0]
    nll = ns.mean(ns.subtract(lse, gold))
    out = {"lse": lse, "gold": gold, "nll": nll, "ppl": ns.exp(nll),
           "acc1": ns.accuracy(lg, lab, k=1),
           "acc5": ns.accuracy(lg, lab, k=5)}
    pred = ns.argmax(lg, axis=-1)
    out["pred"] = pred
    out["agree"] = ns.mean(ns.equal(pred, lab[:, 0]))
    out["topk_v"], out["topk_i"] = ns.topk(lg, k=40)
    order = ns.argsort(lg, axis=-1, descending=True)
    probs = ns.exp(ns.subtract(lg, lse[:, None]))
    cum = ns.cumsum(ns.index_sample(probs, order), axis=1)
    out["order"], out["cum"] = order, cum
    out["q"] = ns.quantile(to(params), [0.5, 0.9, 0.99])
    out["median"] = ns.median(to(params))
    return out


def test_gpt_tiny_evaluation_matches_the_reference():
    logits, labels, params = _gpt_tiny_eval_inputs()
    got = _eval(T, torch.from_numpy, logits, labels, params)
    want = _eval(J, paddle.to_tensor, logits, labels, params)
    for k in want:
        assert_same(got[k], want[k], k)
    # the nucleus cut, row by row (jnp.searchsorted takes one row)
    cut_t = T.searchsorted(got["cum"], torch.full((got["cum"].shape[0], 1),
                                                  0.9))
    cum = np.asarray(want["cum"]._data)
    p_cut = paddle.to_tensor(np.array([0.9], np.float32))
    for i in range(logits.shape[0]):
        row = J.searchsorted(paddle.to_tensor(cum[i]), p_cut)
        assert_same(cut_t[i], row, f"nucleus row {i}")
    ties = sum(len(set(r)) < len(r) for r in logits[::3])
    assert ties >= 5, "the planted ties did not take"
    assert port_np(got["order"]).shape == logits.shape
