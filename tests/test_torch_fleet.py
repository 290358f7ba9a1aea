"""Fleet in collective mode (paddle_tpu_torch/distributed/fleet), held to
the reference's fleet: the strategy and its file, the strategy compiler
(the applied meta-optimizer chain, its conflicts, the Lamb / Lars swap
and the steps it builds, for the strategies of tests/test_fleet_meta.py,
tests/test_dgc.py and tests/test_distributed.py), the role makers on the
``PADDLE_*`` environment, the hybrid communicate group, the metrics, and
``fleet.init`` / ``distributed_optimizer`` / ``train_step`` training an
MLP on two ``LoopbackWorld`` ranks as the reference's fleet trains it on
two CPU devices (2e-6: f32 sums in another order, tanh, SGD).  What waits
for later items raises NotImplementedError naming its ROADMAP item."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import metrics
from paddle_tpu_torch.distributed.fleet.role_maker import (
    PaddleCloudRoleMaker, Role, UserDefinedRoleMaker)
from paddle_tpu_torch.distributed.fleet.strategy import DistributedStrategy
from paddle_tpu_torch.distributed.fleet.strategy_compiler import (
    compile_strategy)
from paddle_tpu_torch.models import load_named_params
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import SGD, Lamb, LarsMomentum, Momentum
from paddle_tpu_torch.parallel import (CompressedAllReduceTrainStep,
                                       DGCTrainStep, LocalSGDTrainStep,
                                       LoopbackWorld, ShardedTrainStep)


def _strategies():
    """(name, world size, {attribute: value}) of the reference tests'
    strategies."""
    return [
        ("default", 8, {}),
        ("lars", 1, {"lars": True}),
        ("lamb", 8, {"lamb": True}),
        ("dgc", 8, {"dgc": True}),
        ("dgc_cfg", 8, {"dgc": True, "dgc_configs": {
            "sparsity": [0.75], "momentum": 0.9, "rampup_begin_step": 0,
            "rampup_step": 1}}),
        ("localsgd", 8, {"localsgd": True, "localsgd_configs": {
            "k_steps": 2, "begin_step": 1}}),
        ("adaptive", 8, {"adaptive_localsgd": True}),
        ("fp16", 8, {"fp16_allreduce": True}),
        ("localsgd_amp", 8, {"localsgd": True, "amp": True,
                             "localsgd_configs": {"k_steps": 2,
                                                  "begin_step": 1}}),
        ("chain", 8, {"amp": True, "recompute": True, "sharding": True,
                      "sharding_configs": {"sharding_degree": 2, "stage": 1},
                      "gradient_merge": True,
                      "gradient_merge_configs": {"k_steps": 2}}),
        ("amp", 8, {"amp": True}),
        ("pure_fp16", 8, {"amp": True, "amp_configs": {
            "use_pure_fp16": True, "use_bf16": False}}),
        ("hybrid_dp2", 8, {"hybrid_configs": {"dp_degree": 8,
                                              "sharding_degree": 1}}),
        ("sharding3", 4, {"sharding": True, "sharding_configs": {
            "sharding_degree": 2, "stage": 3, "gradient_merge_acc_step": 2}}),
        ("localsgd_fp16", 8, {"localsgd": True, "fp16_allreduce": True}),
        ("localsgd_sharding", 8, {"localsgd": True, "sharding": True,
                                  "sharding_configs": {
                                      "sharding_degree": 2, "stage": 1}}),
        ("gm_localsgd", 8, {"localsgd": True, "gradient_merge": True,
                            "gradient_merge_configs": {"k_steps": 4}}),
        ("dgc_localsgd", 8, {"dgc": True, "localsgd": True}),
        ("dgc_fp16", 8, {"dgc": True, "fp16_allreduce": True}),
        ("dgc_sharding", 8, {"dgc": True, "sharding": True,
                             "sharding_configs": {"sharding_degree": 2}}),
        ("exceeds", 2, {"sharding": True}),
    ]


def _build(cls, settings):
    s = cls()
    for k, v in settings.items():
        setattr(s, k, v)
    return s


def _reference_compile(n, settings):
    """(applied, step kwargs, swap, mesh shape) or the exception type."""
    import jax
    from paddle_tpu.distributed.fleet.strategy import DistributedStrategy \
        as JStrategy
    from paddle_tpu.distributed.fleet.strategy_compiler import \
        compile_strategy as jcompile
    try:
        c = jcompile(_build(JStrategy, settings), devices=jax.devices()[:n])
    except ValueError:
        return ValueError
    return (c.applied_meta_list, c.step_kwargs, c.optimizer_swap,
            dict(c.mesh.shape))


def _port_compile(n, settings):
    def fn(rank, mesh):
        try:
            c = compile_strategy(_build(DistributedStrategy, settings))
        except ValueError:
            return ValueError
        return (c.applied_meta_list, c.step_kwargs, c.optimizer_swap,
                dict(c.mesh.shape))
    return LoopbackWorld(n).run(fn)


@pytest.mark.parametrize("name,n,settings", _strategies(),
                         ids=[s[0] for s in _strategies()])
def test_compile_strategy_matches_reference(name, n, settings):
    """The applied meta-optimizer chain in its order, the step's knobs, the
    optimizer swap and the mesh, or the conflict raised, as the
    reference's on the same number of devices."""
    want = _reference_compile(n, settings)
    for got in _port_compile(n, settings):
        assert got == want


def test_model_parallel_degrees_raise_naming_item_3b():
    """An mp degree compiles to ShardedTrainStep over an mp axis (item 3b
    is ported), and a pp degree over a pp axis outermost (item 3c, the
    pipeline, is ported), as the reference's meshes on 2 and 4 devices."""
    s = DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    got = LoopbackWorld(2).run(lambda r, m: dict(compile_strategy(s)
                                                 .mesh.shape))
    assert got == [{"mp": 2}] * 2
    for n, hybrid in ((2, {"pp_degree": 2}),
                      (4, {"pp_degree": 2, "mp_degree": 2})):
        s = DistributedStrategy()
        s.hybrid_configs = hybrid
        got = LoopbackWorld(n).run(lambda r, m: list(compile_strategy(s)
                                                     .mesh.shape.items()))
        want = _reference_compile(n, {"hybrid_configs": hybrid})[3]
        assert got == [list(want.items())] * n and got[0][0] == ("pp", 2)


def test_strategy_validation_and_file_round_trip(tmp_path):
    """As the reference's test_fleet_strategy_roundtrip, and the port's
    file reads back into the reference's strategy (one JSON layout)."""
    from paddle_tpu.distributed.fleet.strategy import DistributedStrategy \
        as JStrategy
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"init_loss_scaling": 1024.0}
    s.recompute = True
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 4, "avg": True}
    with pytest.raises(ValueError):
        s.amp = "yes"
    with pytest.raises(ValueError):
        s.amp_configs = {"bogus_key": 1}
    p = str(tmp_path / "strategy.json")
    s.save_to_prototxt(p)
    s2 = DistributedStrategy()
    s2.load_from_prototxt(p)
    assert s2.amp and s2.gradient_merge_configs["k_steps"] == 4
    assert s2.to_dict() == s.to_dict()
    j = JStrategy()
    j.load_from_prototxt(p)
    assert j.to_dict() == s.to_dict()
    assert DistributedStrategy().to_dict() == JStrategy().to_dict()


def test_lamb_and_lars_swaps_match_reference():
    """lamb / lars swap the user's optimizer for Lamb / LarsMomentum with the
    strategy's coefficients and the user's rate (and momentum)."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.fleet.strategy import DistributedStrategy \
        as JStrategy
    from paddle_tpu.distributed.fleet.strategy_compiler import (
        compile_strategy as jcompile, maybe_swap_optimizer as jswap)
    import jax
    from paddle_tpu_torch.distributed.fleet.strategy_compiler import (
        maybe_swap_optimizer)
    for flag, cfg, cls, attrs in (
            ("lars", {"lars_coeff": 0.01, "lars_weight_decay": 0.001},
             LarsMomentum, ("_lars_coeff", "_lars_weight_decay", "_momentum",
                            "_epsilon")),
            ("lamb", {"lamb_weight_decay": 0.02}, Lamb,
             ("_lamb_wd", "_epsilon"))):
        settings = {flag: True, f"{flag}_configs": cfg}
        jc = jcompile(_build(JStrategy, settings), devices=jax.devices()[:1])
        got = LoopbackWorld(1).run(lambda r, m: maybe_swap_optimizer(
            Momentum(learning_rate=0.3, momentum=0.8),
            compile_strategy(_build(DistributedStrategy, settings))))[0]
        want = jswap(jopt.Momentum(learning_rate=0.3, momentum=0.8), jc)
        assert type(got) is cls and type(want).__name__ == cls.__name__
        assert got.get_lr() == want.get_lr() == 0.3
        for a in attrs:
            assert getattr(got, a) == getattr(want, a), a


def test_train_step_builds_the_strategys_step():
    """train_step returns the dp_meta step of LocalSGD, DGC and
    fp16_allreduce, with their configs, and ShardedTrainStep otherwise."""
    m = Linear(4, 2, device="cpu")

    def fn(rank, mesh):
        out = {}
        for name, settings in (
                ("localsgd", {"localsgd": True, "localsgd_configs": {
                    "k_steps": 2, "begin_step": 1}}),
                ("adaptive", {"adaptive_localsgd": True,
                              "adaptive_localsgd_configs": {
                                  "init_k_steps": 3, "begin_step": 2}}),
                ("dgc", {"dgc": True, "dgc_configs": {"sparsity": [0.75]}}),
                ("fp16", {"fp16_allreduce": True}),
                ("sharding", {"sharding": True, "sharding_configs": {
                    "sharding_degree": 2, "stage": 2}}),
                ("amp", {"amp": True})):
            c = compile_strategy(_build(DistributedStrategy, settings))
            out[name] = c.train_step(m, lambda mm, x: mm(x).sum(), SGD())
        return out
    got = LoopbackWorld(2).run(fn)[0]
    assert type(got["localsgd"]) is LocalSGDTrainStep
    assert got["localsgd"].k_steps == 2
    assert got["adaptive"].adaptive and got["adaptive"].k_steps == 3
    assert got["adaptive"].begin_step == 2
    assert type(got["dgc"]) is DGCTrainStep
    assert got["dgc"].sparsity == [0.75]
    assert type(got["fp16"]) is CompressedAllReduceTrainStep
    assert type(got["sharding"]) is ShardedTrainStep
    assert got["sharding"].sharding_stage == 2
    assert got["sharding"].data_axes == ("sharding",)
    assert got["amp"].amp_level == "O1"


ENV = {"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "3",
       "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6070,10.0.0.2:6070,"
       "10.0.0.3:6070",
       "PADDLE_PSERVERS_IP_PORT_LIST": "10.0.0.9:6000,10.0.0.8:6000",
       "TRAINING_ROLE": "TRAINER"}


def _role_readings(rm):
    return (rm.is_worker(), rm.is_server(), rm.is_first_worker(),
            rm.worker_index(), rm.server_index(), rm.worker_num(),
            rm.server_num(), rm.get_trainer_endpoints(),
            rm.get_pserver_endpoints())


def test_role_makers_read_the_environment_as_the_reference(monkeypatch):
    """PaddleCloudRoleMaker (collective and PS roles) and
    UserDefinedRoleMaker give the reference's readings; refresh() re-reads
    the environment, refresh(store=...) takes the rank and the world from
    a rendezvous store's live members as the reference's does."""
    from paddle_tpu.distributed.fleet import role_maker as jrm
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    for collective in (True, False):
        assert _role_readings(PaddleCloudRoleMaker(collective)) == \
            _role_readings(jrm.PaddleCloudRoleMaker(collective))
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVER_ID", "1")
    assert _role_readings(PaddleCloudRoleMaker()) == _role_readings(
        jrm.PaddleCloudRoleMaker())
    kw = dict(current_id=2, role=Role.SERVER,
              worker_endpoints=["a:1", "b:2"], server_endpoints=["c:3"])
    assert _role_readings(UserDefinedRoleMaker(**kw)) == _role_readings(
        jrm.UserDefinedRoleMaker(**{**kw, "role": jrm.Role.SERVER}))
    rm = PaddleCloudRoleMaker(is_collective=True)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    assert rm.worker_index() == 1 and rm.refresh().worker_index() == 2
    from paddle_tpu.distributed import elastic as jel
    from paddle_tpu_torch.distributed import elastic as tel
    readings = []
    for el, mk in ((tel, PaddleCloudRoleMaker),
                   (jel, jrm.PaddleCloudRoleMaker)):
        store = el.DictStore(ttl=5.0, clock=lambda: 0.0)
        for w in ("w0", "w1", "w2"):
            store.register(w, endpoint=f"h{w[1]}:1")
        r = mk(is_collective=True).refresh(store=store, worker_id="w1")
        readings.append((r.worker_index(), r.worker_num(),
                         r.get_trainer_endpoints(), r._elastic_epoch))
        with pytest.raises(el.Evicted):
            mk(is_collective=True).refresh(store=store, worker_id="w9")
    assert readings[0] == readings[1] == (1, 3, ["h0:1", "h1:1", "h2:1"], 3)


def test_metrics_merge_over_the_ranks():
    """sum / max / min / auc / mae / mse / rmse / acc over two ranks: the
    reference's merged statistics, each crossing in f32 and coming back as
    f64 (a value f32 cannot hold comes back rounded)."""
    from paddle_tpu.distributed.fleet import metrics as jm
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 50, (2, 10)).astype(np.float64)
    neg = rng.integers(0, 50, (2, 10)).astype(np.float64)
    stat = np.array([[1.0 + 2 ** -40, 5.0], [3.0, -2.0]])

    def fn(rank, mesh):
        return (metrics.sum(stat[rank]), metrics.max(stat[rank]),
                metrics.min(stat[rank]), metrics.auc(pos[rank], neg[rank]),
                metrics.mae(pos[rank], neg[rank]),
                metrics.mse(pos[rank], neg[rank]),
                metrics.rmse(pos[rank], neg[rank]),
                metrics.acc(pos[rank][:3], neg[rank][:3] + 50))
    got = LoopbackWorld(2).run(fn)
    s32 = stat.astype(np.float32).astype(np.float64)
    want = (s32.sum(0), s32.max(0), s32.min(0), jm.auc(pos.sum(0),
                                                        neg.sum(0)),
            jm.mae(pos.sum(0), neg.sum(0)), jm.mse(pos.sum(0), neg.sum(0)),
            jm.rmse(pos.sum(0), neg.sum(0)),
            jm.acc(pos[:, :3].sum(0), (neg[:, :3] + 50).sum(0)))
    for g in got:
        for a, b in zip(g, want):
            np.testing.assert_allclose(a, b, rtol=1e-12)
        assert g[0].dtype == np.float64 and g[0][0] == 4.0
    assert metrics.sum(stat[0])[0] == stat[0][0]        # one rank: as is


def _mlp_weights():
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    paddle.seed(0)
    m = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 1))
    return m, {n: np.asarray(p._data) for n, p in m.named_parameters()}


def _batch():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    return x, (x.sum(1, keepdims=True) / 4).astype(np.float32)


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def test_fleet_trains_as_the_reference_fleet():
    """fleet.init(is_collective=True) with sharding stage 2 over two ranks,
    distributed_optimizer, train_step: three steps' losses and parameters
    as the reference fleet's on two devices; the worker queries, the
    hybrid group and applied_meta_list; a DataParallel model
    (distributed_model) trains as the layer it wraps."""
    import paddle_tpu as paddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.parallel import get_mesh, set_mesh
    jm, weights = _mlp_weights()
    settings = {"sharding": True, "sharding_configs": {
        "sharding_degree": 2, "stage": 2, "dp_degree": 1},
        "hybrid_configs": {"dp_degree": 1}}
    x, y = _batch()
    prev = get_mesh()
    try:
        jfleet.init(is_collective=True,
                    strategy=_build(jfleet.DistributedStrategy, settings))
        jopt_ = jfleet.distributed_optimizer(jopt.SGD(
            learning_rate=0.1, parameters=jm.parameters()))
        js = jfleet.train_step(jm, _mse, jopt_)
        want = [float(js(paddle.to_tensor(x), paddle.to_tensor(y)))
                for _ in range(3)]
        want_applied = jfleet.applied_meta_list()
    finally:
        set_mesh(prev)
    want_p = {n: np.asarray(p._data) for n, p in jm.named_parameters()}

    def fn(rank, mesh):
        fleet.init(is_collective=True,
                   strategy=_build(DistributedStrategy, settings))
        m = load_named_params(torch.nn.Sequential(
            Linear(8, 16, device="cpu"), torch.nn.Tanh(),
            Linear(16, 1, device="cpu")), weights)
        dm = fleet.distributed_model(m)
        step = fleet.train_step(dm, _mse, fleet.distributed_optimizer(
            SGD(learning_rate=0.1)))
        losses = [float(step(x, y)) for _ in range(3)]
        hcg = fleet.get_hybrid_communicate_group()
        fleet.barrier_worker()
        return (losses, {n: p.detach().numpy() for n, p in
                         m.named_parameters()}, fleet.applied_meta_list(),
                (fleet.worker_index(), fleet.worker_num(), fleet.is_worker(),
                 fleet.is_first_worker()),
                (hcg.get_sharding_parallel_world_size(),
                 hcg.get_sharding_parallel_rank(),
                 hcg.get_data_parallel_world_size(),
                 hcg.get_model_parallel_world_size(),
                 hcg.get_data_parallel_group().nranks,
                 hcg.get_sharding_parallel_group().nranks),
                type(step).__name__)
    got = LoopbackWorld(2).run(fn)
    for r, (losses, params, applied, queries, hcg, kind) in enumerate(got):
        np.testing.assert_allclose(losses, want, rtol=2e-6, atol=2e-6)
        for n, v in want_p.items():
            np.testing.assert_allclose(params[n], v, rtol=2e-6, atol=2e-6)
        assert applied == want_applied
        assert queries == (r, 1, True, r == 0)
        assert hcg == (2, r, 1, 1, 1, 2)
        assert kind == "ShardedTrainStep"
    assert fleet.utils.recompute is fleet.recompute


# item 3b's, 3c's, 4a's and 4b's names are ported (None): real, not
# stand-ins
PENDING = [("distributed", n, None) for n in (
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "shard_tensor", "split")] + [("parallel", n, None) for n in (
        "make_pipeline_train_1f1b", "pipeline_forward")] + [
    ("parallel", n, None) for n in ("ring_attention", "shard_map_compat")] + [
    ("parallel", "pipeline", None)] + [
    ("distributed", "ps", None)] + [
    ("distributed", n, None) for n in ("DatasetFactory", "InMemoryDataset",
                                       "QueueDataset", "train_from_dataset")
] + [("distributed.ps", n, None) for n in ("service", "graph")] + [
    ("distributed.fleet", n, None) for n in ("init_worker", "ps_client",
                                             "init_server", "run_server",
                                             "stop_worker")] + [
    ("distributed.fleet", "save_inference_model", None),
    ("distributed.fleet", "save_persistables", None),
    ("distributed", "checkpoint", None),
    ("distributed.fleet.utils", "fs", None),
    ("distributed", "elastic", None), ("distributed", "launch", None),
    ("parallel", "parity", None)] + [
    ("framework", n, None) for n in ("numerics", "auto_checkpoint")] + [
    ("framework", n, None) for n in ("incident", "resilient",
                                     "ResilientTrainStep")] + [
    ("framework", "errors", "7"), ("framework", "analysis", "8")] + [
    ("framework", n, None) for n in ("monitor", "chaos", "observability")]


@pytest.mark.parametrize("module,name,item", PENDING,
                         ids=[f"{m}.{n}" for m, n, _ in PENDING])
def test_names_left_for_later_items_raise_naming_them(module, name, item):
    """Every reference name left for items 7 and 8 raises
    NotImplementedError naming its ROADMAP item, where the reference has
    it; item 3b's, 3c's, 4a's, 4b's, 5's, 6a's and 6b's names (item None)
    are real, not stand-ins (the ``pipeline``, ``ps``, ``ps.service`` and
    ``ps.graph`` submodules, the datasets, fleet's PS lifecycle and
    savers, the checkpoints, ``fs``, numerics, the planes, ``elastic``,
    ``launch``, ``parity``, ``incident``, ``resilient``); a name neither
    package has is an AttributeError."""
    import importlib
    mod = importlib.import_module(f"paddle_tpu_torch.{module}")
    ref = importlib.import_module(f"paddle_tpu.{module}")
    assert hasattr(ref, name) or importlib.util.find_spec(
        f"paddle_tpu.{module}.{name}") is not None
    if item is None:
        got = getattr(mod, name)
        assert getattr(got, "__module__", getattr(got, "__name__", None)) \
            not in ("paddle_tpu_torch._pending", None)
    else:
        with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
            getattr(mod, name)(None, (2, 2), "linear")
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")
