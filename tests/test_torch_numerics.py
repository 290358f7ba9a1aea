"""The port's numerics plane (paddle_tpu_torch/framework/numerics.py, wired
into TrainStep, ShardedUpdateTrainStep and PSTrainStep) against the
reference's on the CPU.

``compute_aux`` takes the same numpy gradients and parameters in both
packages (one leaf with a NaN planted); the records agree within 1e-5
relative on every norm, max-abs and ratio, exactly on the counts and on
``first_bad_leaf``.  A ``gpt_tiny`` (2 layers, H = 128, S = 128) AdamW
step armed in both packages gives records within 1e-5 (the two sum the
f32 gradients in different orders; test_torch_train holds the gradients
themselves at 1e-4).  The publish path writes the reference's monitor
names in both.  Disarmed, a port step returns no record.  The ZeRO step
at dp = 2 on ``LoopbackWorld`` ranks publishes the replicated step's
global norms within 1e-5.  The embedding gradient behind GPT's pp-stage
agreement is bitwise repeatable on the CPU without deterministic
algorithms (``F.embedding``, which adds each row in index order).
"""
import threading

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import numerics as jnum
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.parallel import get_mesh, make_mesh, set_mesh
from paddle_tpu_torch.framework import numerics as tnum
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPT, gpt_loss, gpt_tiny
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import LoopbackWorld
from paddle_tpu_torch.parallel.zero import ShardedUpdateTrainStep

from torch_planes_common import PORT, REF, clean_planes

REL = 1e-5
TINY = dict(num_layers=2, hidden_size=128, num_heads=2, max_seq_len=128,
            remat=False)
FLOATS = ("grad_norm", "param_norm", "update_ratio", "max_abs_grad")


def _close(a, b, rel=REL):
    if np.isnan(a) or np.isnan(b):
        assert np.isnan(a) and np.isnan(b), (a, b)
        return
    assert abs(a - b) <= rel * max(abs(a), abs(b), 1e-30), (a, b)


def _same_record(got, want, rel=REL):
    g, w = got.to_dict(), want.to_dict()
    for k in FLOATS:
        _close(g[k], w[k], rel)
    assert g["nonfinite"] == w["nonfinite"]
    assert g["first_bad_leaf"] == w["first_bad_leaf"]
    assert got.names == want.names
    gl, wl = got.per_leaf(), want.per_leaf()
    for n in wl:
        for k in ("grad_norm", "param_norm", "update_ratio",
                  "max_abs_grad"):
            if np.isfinite(wl[n][k]):
                _close(gl[n][k], wl[n][k], rel)
            else:
                assert not np.isfinite(gl[n][k])
        assert gl[n]["nonfinite"] == wl[n]["nonfinite"]


def _tree(seed, nan_leaf=None):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 8), "b": (8,), "emb": (32, 4), "s": ()}
    g = {n: np.asarray(rng.standard_normal(s), np.float32)
         for n, s in shapes.items()}
    p = {n: np.asarray(rng.standard_normal(s), np.float32)
         for n, s in shapes.items()}
    q = {n: np.asarray(p[n] - 0.01 * g[n], np.float32) for n in shapes}
    if nan_leaf is not None:
        g[nan_leaf] = g[nan_leaf].copy()
        g[nan_leaf].reshape(-1)[3] = np.nan
    return g, p, q


@pytest.mark.parametrize("nan_leaf", [None, "emb"])
def test_compute_aux_matches_reference(nan_leaf):
    """The same arrays through both packages' compute_aux and record:
    norms 1e-5, counts and first_bad_leaf exactly; the port's aux is
    views of one float64 buffer."""
    g, p, q = _tree(1, nan_leaf)
    want = jnum.NumericsRecord(list(g), jax.jit(jnum.compute_aux)(
        g, p, q, np.float32(1.5)))
    t = {k: {n: torch.from_numpy(v.copy()) for n, v in d.items()}
         for k, d in (("g", g), ("p", p), ("q", q))}
    aux = tnum.compute_aux(t["g"], t["p"], t["q"], torch.tensor(1.5))
    assert set(aux) == set(tnum.AUX_KEYS)
    base = aux["grad_sq"]._base
    assert base is not None and base.dtype == torch.float64
    assert all(v._base is base for v in aux.values())
    got = tnum.NumericsRecord(list(g), aux)
    _same_record(got, want)
    assert got.first_bad_leaf() == ("emb" if nan_leaf else None)
    assert got.bad_leaves() == want.bad_leaves()


@pytest.fixture(scope="module")
def gpt_records():
    """One armed AdamW step of gpt_tiny in each package from the same
    weights and ids, the monitor names after it, then one more step of
    each with ``lnf_b`` made NaN (every gradient non-finite)."""
    prev = get_mesh()
    set_mesh(make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jfa._INTERPRET = True
    ids = np.random.default_rng(3).integers(0, 256, (2, 128)).astype(
        np.int32)
    out = {}
    try:
        with clean_planes({"numerics": True, "numerics_sample_every": 1}):
            paddle.seed(0)
            jm = jgpt.GPT(jgpt.gpt_tiny(**TINY))
            init = {n: np.array(jm._parameters[n]._data)
                    for n in jgpt._PARAM_ORDER}
            jstep = JTrainStep(jm, jgpt.gpt_loss, jopt.AdamW(
                learning_rate=1e-3, parameters=jm.parameters()))
            jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
            out["ref"] = jstep.last_numerics
            tm = GPT(gpt_tiny(**TINY), device="cpu").load_jax_params(init)
            tstep = TrainStep(tm, gpt_loss, AdamW(learning_rate=1e-3))
            tstep(torch.from_numpy(ids), torch.from_numpy(ids))
            out["port"] = tstep.last_numerics
            out["names"] = {
                tag: sorted(k for k in pkg.monitor.all_stats()
                            if k.startswith("numerics_"))
                for tag, pkg in (("ref", REF), ("port", PORT))}
            out["hists"] = {tag: sorted(pkg.monitor.all_histograms())
                            for tag, pkg in (("ref", REF), ("port", PORT))}
            # the same steps again with lnf_b made NaN: every gradient is
            # non-finite (the reference's compiled step is reused)
            jm._parameters["lnf_b"]._data = jax.numpy.full_like(
                jm._parameters["lnf_b"]._data, np.nan)
            jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
            out["ref_bad"] = jstep.last_numerics
            with torch.no_grad():
                tm.lnf_b.fill_(float("nan"))
            tstep(torch.from_numpy(ids), torch.from_numpy(ids))
            out["port_bad"] = tstep.last_numerics
    finally:
        jfa._INTERPRET = False
        set_mesh(prev)
    return out


def test_train_step_record_matches_reference(gpt_records):
    """The armed gpt_tiny step's record: global and per-leaf norms,
    ratios and max-abs within 1e-5 of the reference's, no non-finite
    value; the same monitor gauges and histograms published."""
    _same_record(gpt_records["port"], gpt_records["ref"])
    assert gpt_records["port"].finite()
    names = gpt_records["names"]
    assert names["port"] == names["ref"]
    assert "numerics_grad_norm" in names["port"]
    assert any("[wte]" in n for n in names["port"])
    hists = gpt_records["hists"]
    for tag in ("port", "ref"):
        assert {"grad_norm", "param_norm", "update_ratio"} <= set(hists[tag])


def test_train_step_names_first_bad_leaf(gpt_records):
    """A NaN parameter: both records count the same non-finite values
    and name the same first bad leaf."""
    port, ref = gpt_records["port_bad"], gpt_records["ref_bad"]
    assert not port.finite() and not ref.finite()
    assert port.first_bad_leaf() == ref.first_bad_leaf() is not None
    assert port.nonfinite_grads == ref.nonfinite_grads
    assert port.nonfinite_loss == ref.nonfinite_loss == 1


def test_disarmed_step_has_no_record():
    """FLAGS_numerics off: the step leaves no record and publishes
    nothing."""
    with clean_planes({"numerics": False}):
        m = torch.nn.Linear(4, 2)
        from paddle_tpu_torch.optimizer import SGD
        step = TrainStep(m, lambda mod, x: mod(x).square().mean(),
                         SGD(learning_rate=0.1))
        step(torch.ones(3, 4))
        assert getattr(step, "last_numerics", None) is None
        assert not any(k.startswith("numerics_")
                       for k in PORT.monitor.all_stats())


def test_publish_fault_is_swallowed():
    """The numerics.observe chaos point: the publish is dropped and
    counted in both packages, the record itself stays readable."""
    g, p, q = _tree(2)
    t = {k: {n: torch.from_numpy(v.copy()) for n, v in d.items()}
         for k, d in (("g", g), ("p", p), ("q", q))}
    with clean_planes():
        for pkg, rec in (
                (REF, jnum.NumericsRecord(list(g), jax.jit(
                    jnum.compute_aux)(g, p, q, np.float32(1.0)))),
                (PORT, tnum.NumericsRecord(list(g), tnum.compute_aux(
                    t["g"], t["p"], t["q"], torch.tensor(1.0))))):
            mod = jnum if pkg is REF else tnum
            with pkg.chaos.inject("numerics.observe", mode="error", nth=1):
                assert mod.publish(rec) is None
            assert pkg.monitor.get_stat(
                "numerics_observe_errors_total") == 1
            assert rec.grad_norm > 0


def _zero_model(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                               torch.nn.Linear(5, 3))


def test_zero_dp2_publishes_global_norms():
    """ShardedUpdateTrainStep at dp = 2 on the f32 wire (LoopbackWorld
    ranks): rank 0's
    record holds the global norms the replicated TrainStep's record holds
    on the same batch, within 1e-5; the per-leaf counts agree."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 6)).astype(np.float32))

    def loss(m, xb):
        return m(xb).square().mean()

    state = _zero_model(0).state_dict()
    with clean_planes({"numerics": True}):
        ref = _zero_model(0)
        ref.load_state_dict(state)
        rstep = TrainStep(ref, loss, AdamW(learning_rate=1e-2))
        rstep(x)
        want = rstep.last_numerics

        def fn(rank, mesh):
            m = _zero_model(0)
            m.load_state_dict(state)
            step = ShardedUpdateTrainStep(m, loss, AdamW(learning_rate=1e-2),
                                          mesh=mesh, wire_dtype="f32")
            step(x)
            return getattr(step, "last_numerics", None)
        got = LoopbackWorld(2).run(fn)
    assert got[1] is None
    for k in ("grad_norm", "param_norm", "update_norm"):
        _close(getattr(got[0], k), getattr(want, k))
    assert got[0].nonfinite_grads == 0 and got[0].names == want.names


def test_embedding_gradient_is_repeatable_across_threads():
    """GPT's lookup (F.embedding): the table's gradient is bitwise the
    same on two threads and on every call, with deterministic algorithms
    off — the property GPT's pp stages rely on, each computing its own
    copy of wte's gradient."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        gen = torch.Generator().manual_seed(0)
        w = torch.randn(256, 64, generator=gen, requires_grad=True)
        ids = torch.randint(0, 256, (8, 256), generator=gen)
        g = torch.randn(8, 256, 64, generator=gen)

        def grad():
            return torch.autograd.grad(
                torch.nn.functional.embedding(ids, w), w, g)[0]
        ref = grad()
        bad = []

        def worker():
            for _ in range(20):
                bad.append(not torch.equal(grad(), ref))
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(bad) == 40 and not any(bad)
    finally:
        torch.use_deterministic_algorithms(was)


def test_ps_train_step_record_matches_reference():
    """PSTrainStep armed, 3 steps of WideDeepHost over a 1,000 x 9 adagrad
    host table (``test_torch_ps``'s set-up): the last step's record,
    the pulled rows a leaf ("embedding.rows", their update term zero),
    within 1e-5 of the reference's."""
    from paddle_tpu.parallel import make_mesh as jmake_mesh
    from test_torch_ps import _ps_data, _ps_port, _ps_ref
    prev = get_mesh()
    set_mesh(jmake_mesh({"dp": 1}))
    try:
        with clean_planes({"numerics": True}):
            data = _ps_data(seed=1, hi=50)
            import paddle_tpu.distributed.ps as jps
            made = []
            orig = jps.PSTrainStep.__init__

            def keep(self, *a, **k):
                orig(self, *a, **k)
                made.append(self)
            jps.PSTrainStep.__init__ = keep
            try:
                init = _ps_ref("float32", False, data)[0]
            finally:
                jps.PSTrainStep.__init__ = orig
            step = _ps_port("float32", False, data, init)[0]
            want, got = made[0].last_numerics, step.last_numerics
    finally:
        set_mesh(prev)
    assert "embedding.rows" in got.names
    assert got.per_leaf()["embedding.rows"]["update_ratio"] == 0.0
    _same_record(got, want)


SH_CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=64, remat=False)


def _sh_ids():
    return np.random.default_rng(9).integers(0, 256, (4, 64)).astype(
        np.int64)


@pytest.fixture(scope="module")
def sharded_reference():
    """The reference's ShardedTrainStep at mp = 2 (2 of the 8 virtual
    devices), one Adam step armed: its initial parameters and record."""
    from paddle_tpu.models.gpt import _PARAM_ORDER
    from paddle_tpu.parallel.sharded import ShardedTrainStep as JSharded
    with clean_planes({"numerics": True}):
        model = jgpt.GPT(jgpt.GPTConfig(**SH_CFG))
        init = {n: np.asarray(model._parameters[n]._data)
                for n in _PARAM_ORDER}
        prev = get_mesh()
        mesh = set_mesh(make_mesh({"mp": 2}))
        try:
            step = JSharded(model, jgpt.gpt_loss, jopt.Adam(
                learning_rate=1e-3, parameters=model.parameters()),
                mesh=mesh)
            ids = paddle.to_tensor(_sh_ids())
            step(ids, ids)
        finally:
            set_mesh(prev)
        rec = step.last_numerics
        rec.to_dict()                       # read while the planes are set
        return init, rec


def _port_sharded(init, axes, stage, armed):
    from paddle_tpu_torch.models import GPTConfig, shard_params
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import ShardedTrainStep
    ids = torch.from_numpy(_sh_ids())

    def fn(rank, mesh):
        model = GPT(GPTConfig(**SH_CFG), device="cpu", mesh=mesh)
        shards = shard_params(init, mesh.shape.get("mp", 1),
                              mesh.axis_index("mp"))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(shards[name])
        step = ShardedTrainStep(model, gpt_loss, Adam(learning_rate=1e-3),
                                mesh=mesh, sharding_stage=stage)
        loss = step(ids, ids)
        rec = getattr(step, "last_numerics", None)
        if rec is not None:
            rec.to_dict()
        return (loss.numpy(), {k: v.numpy() for k, v in
                               step.gather_params().items()}, rec)
    with clean_planes({"numerics": armed}):
        return LoopbackWorld(int(np.prod(list(axes.values())))).run(
            fn, axes=axes)


@pytest.mark.parametrize("axes,stage", [({"mp": 2}, 0),
                                        ({"dp": 2, "mp": 2}, 2)])
def test_sharded_step_record_matches_reference(sharded_reference, axes,
                                               stage):
    """ShardedTrainStep with FLAGS_numerics at mp = 2 (alone, and with
    dp = 2 at ZeRO stage 2): every rank's record equals rank 0's bitwise
    (the sums over mp and the ZeRO group run in rank order) and matches
    the reference's record within 1e-5 on every norm, ratio and count.
    Disarmed, the step leaves no record and its loss and parameters are
    bitwise the armed run's."""
    init, want = sharded_reference
    got = _port_sharded(init, axes, stage, armed=True)
    for r in got:
        assert r[2].per_leaf() == got[0][2].per_leaf()
    _same_record(got[0][2], want)
    plain = _port_sharded(init, axes, stage, armed=False)
    assert plain[0][2] is None
    assert np.array_equal(plain[0][0], got[0][0])
    for k, v in got[0][1].items():
        assert np.array_equal(plain[0][1][k], v), k


def test_sharded_record_needs_the_mp_sum(sharded_reference):
    """A planted fault: leaving out the sum over mp for the split leaves
    (each rank's record then holds its own shard's norms) moves the
    split leaves' norms off the reference's."""
    from paddle_tpu_torch.parallel import sharded
    init, want = sharded_reference
    real = tnum.sum_aux_over

    def no_mp(aux, axes):
        return real(aux, [a for a in axes if a[0].size != 2 or
                          not any(a[1]) or all(a[1])])
    sharded.numerics.sum_aux_over = no_mp
    try:
        got = _port_sharded(init, {"mp": 2}, 0, armed=True)
    finally:
        sharded.numerics.sum_aux_over = real
    wl, gl = want.per_leaf(), got[0][2].per_leaf()
    off = [n for n in wl if abs(gl[n]["grad_norm"] - wl[n]["grad_norm"])
           > REL * wl[n]["grad_norm"]]
    assert "qkv_w" in off and "wpe" not in off, off


PP_RUNS = {"pp2_mode0": ({"pp": 2}, 0),
           "pp2_mp2_mode1": ({"pp": 2, "mp": 2}, 1)}


@pytest.fixture(scope="module")
def pp_reference():
    """The reference's ShardedTrainStep (stage 1, as the pipeline tests
    run it) at pp = 2 in F-then-B and at pp x mp in 1F1B, two
    microbatches, one Adam step armed: its initial parameters and
    record, by run."""
    from paddle_tpu.models.gpt import _PARAM_ORDER
    from paddle_tpu.parallel.sharded import ShardedTrainStep as JSharded
    out = {}
    for name, (axes, mode) in PP_RUNS.items():
        with clean_planes({"numerics": True}):
            model = jgpt.GPT(jgpt.GPTConfig(n_microbatches=2,
                                            schedule_mode=mode, **SH_CFG))
            init = {n: np.asarray(model._parameters[n]._data)
                    for n in _PARAM_ORDER}
            prev = get_mesh()
            mesh = set_mesh(make_mesh(axes))
            try:
                step = JSharded(model, jgpt.gpt_loss, jopt.Adam(
                    learning_rate=1e-3, parameters=model.parameters()),
                    mesh=mesh, sharding_stage=1)
                ids = paddle.to_tensor(_sh_ids())
                step(ids, ids)
            finally:
                set_mesh(prev)
            rec = step.last_numerics
            rec.to_dict()
            out[name] = (init, rec)
    return out


def _port_pp(init, axes, mode):
    """The port's ShardedTrainStep (stage 1) on LoopbackWorld ranks laid
    out as ``axes``, each holding its stage and mp shards of ``init``,
    one step armed: each rank's record."""
    from paddle_tpu_torch.models import GPTConfig, shard_params
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import ShardedTrainStep
    ids = torch.from_numpy(_sh_ids())

    def fn(rank, mesh):
        model = GPT(GPTConfig(n_microbatches=2, schedule_mode=mode,
                              **SH_CFG), device="cpu", mesh=mesh)
        part = shard_params(init, mesh.shape.get("mp", 1),
                            mesh.axis_index("mp"), pp=mesh.shape["pp"],
                            stage=mesh.axis_index("pp"))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(part[name])
        step = ShardedTrainStep(model, gpt_loss, Adam(learning_rate=1e-3),
                                mesh=mesh, sharding_stage=1)
        step(ids, ids)
        rec = step.last_numerics
        rec.to_dict()
        return rec
    with clean_planes({"numerics": True}):
        return LoopbackWorld(int(np.prod(list(axes.values())))).run(
            fn, axes=axes)


@pytest.mark.parametrize("run", list(PP_RUNS))
def test_pp_sharded_record_matches_reference(pp_reference, run):
    """ShardedTrainStep with FLAGS_numerics at pp = 2 (F-then-B) and pp x
    mp (1F1B): every rank's record equals rank 0's bitwise, and matches
    the reference's within 1e-5 on every norm, ratio and count (the
    stacked layers summed over pp, the leaves outside the stack, the
    tied wte among them, counted once)."""
    axes, mode = PP_RUNS[run]
    init, want = pp_reference[run]
    got = _port_pp(init, axes, mode)
    for r in got:
        assert r.per_leaf() == got[0].per_leaf()
    _same_record(got[0], want)


def test_pp_record_needs_the_pp_sum(pp_reference):
    """A planted fault: leaving out the sum over pp (each stage's record
    then holds its own layer's norms) moves the stacked leaves' norms off
    the reference's, and no other leaf's."""
    from paddle_tpu_torch.parallel import sharded
    init, want = pp_reference["pp2_mode0"]
    real = tnum.sum_aux_over

    def no_pp(aux, axes):
        return real(aux, [a for a in axes if a[0].size != 2 or all(a[1])])
    sharded.numerics.sum_aux_over = no_pp
    try:
        got = _port_pp(init, {"pp": 2}, 0)
    finally:
        sharded.numerics.sum_aux_over = real
    wl, gl = want.per_leaf(), got[0].per_leaf()
    off = {n for n in wl if abs(gl[n]["grad_norm"] - wl[n]["grad_norm"])
           > REL * wl[n]["grad_norm"]}
    stacked = {"ln1_w", "ln1_b", "qkv_w", "qkv_b", "prj_w", "prj_b",
               "ln2_w", "ln2_b", "fc_w", "fc_b", "out_w", "out_b"}
    assert off == stacked, off
