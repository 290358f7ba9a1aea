"""The port stands alone: no module of paddle_tpu_torch, and not
chip_smoke.py, imports jax, ml_dtypes or paddle_tpu; the card is the
default device and its absence raises instead of running on the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.models import GPT, gpt_tiny
from paddle_tpu_torch.ops.cuda import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    mods = [m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
    for m in ("models.gpt", "distributed.wire", "ops.cuda.ring_quant",
              "parallel.mesh", "parallel.ring", "parallel.dp_meta",
              "parallel.zero", "jit.recompute", "framework.replay",
              "distributed.fleet",
              "distributed.fleet.utils", "nn.decode", "nn.layer.rnn",
              "nn.layer.loss", "amp", "regularizer", "nn.initializer",
              "framework.parameter", "nn.layer.activation",
              "vision.models.mobilenet", "vision.models.vgg",
              "nn.functional.extras", "nn.functional.pooling",
              "nn.functional.common", "nn.functional.loss",
              "nn.layer.pooling", "nn.layer.conv", "vision.transforms",
              "nn.layer.layers", "nn.layer.norm", "nn.functional.norm",
              "nn.utils", "framework.selected_rows", "vision.ops",
              "framework.dtype", "tensor", "tensor.creation",
              "tensor.math", "tensor.linalg", "tensor.logic", "tensor.stat",
              "tensor.search", "tensor.manipulation", "tensor.random",
              "tensor.sequence", "autograd", "framework.io", "static",
              "static.nn", "jit.dy2static", "jit.static",
              "framework.crypto", "inference", "quantization",
              "distributed.collective", "distributed.parallel",
              "distributed.spawn", "distributed.fleet.strategy",
              "distributed.fleet.role_maker", "distributed.fleet.topology",
              "distributed.fleet.strategy_compiler",
              "distributed.fleet.metrics", "parallel.sharded",
              "parallel.tp", "parallel.ring_attention",
              "distributed.tp_layers", "parallel.pipeline",
              "distributed.ps", "distributed.ps.device_table",
              "models.rank", "framework.monitor", "framework.locks",
              "framework.chaos", "framework.observability",
              "framework.health", "profiler", "distributed.ps.service",
              "distributed.ps.graph", "distributed.dataset", "ops.native",
              "io", "io._worker", "io.dataset_cache", "io.pipeline",
              "vision.datasets", "text", "text.datasets", "dataset",
              "dataset.common", "dataset.mnist", "dataset.cifar",
              "dataset.imdb", "dataset.imikolov", "dataset.uci_housing",
              "dataset.movielens", "dataset.flowers", "dataset.voc2012",
              "dataset.wmt14", "dataset.wmt16", "dataset.conll05",
              "reader", "distributed.fleet.utils.fs",
              "distributed.checkpoint", "distributed.durable",
              "framework.numerics", "framework.auto_checkpoint",
              "parallel.parity", "framework.blame", "framework.runlog",
              "framework.incident", "framework.resilient",
              "framework.collector", "framework.autopilot",
              "distributed.elastic", "distributed.launch", "tools.replay"):
        assert f"paddle_tpu_torch.{m}" in mods
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_ps_transport_graph_and_datasets_run_with_jax_blocked(tmp_path):
    """The PS server and client, the graph table served remotely, the
    native datafeed, the datasets, train_from_dataset and fleet's server
    role run in a process where jax, ml_dtypes and paddle_tpu cannot be
    imported, and leave none of them in sys.modules."""
    data = tmp_path / "part-0"
    data.write_text("".join(f"1 {i % 7} 1 {i % 2}\n" for i in range(12)))
    code = f"""
import os, sys, threading
for name in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'):
    sys.modules[name] = None
import numpy as np, torch
from paddle_tpu_torch.distributed import (DatasetFactory, fleet,
                                          train_from_dataset)
from paddle_tpu_torch.distributed.ps import HostEmbeddingTable
from paddle_tpu_torch.distributed.ps.graph import GraphTable, RemoteGraphTable
from paddle_tpu_torch.distributed.ps.service import (PsClient, PsServer,
                                                     RemoteEmbeddingTable)
from paddle_tpu_torch.ops.native import MultiSlotDataFeed
g = GraphTable(embedding_dim=2)
g.add_edges([0, 0], [1, 2], bidirectional=True)
srv = PsServer({{"emb": HostEmbeddingTable(8, 2), "g": g}}).start()
c = PsClient([f"127.0.0.1:{{srv.port}}"])
t = RemoteEmbeddingTable(c, "emb", 2)
t.push_pull(np.array([1]), np.ones((1, 2), np.float32), np.arange(4))
assert RemoteGraphTable(c, "g").sample_neighbors(np.array([0]), 2)[1][0] == 2
c.bye()
srv.shutdown()
slots = [("ids", "u", 0), ("label", "f", 1)]
assert len(list(MultiSlotDataFeed(slots, 4, files=[{str(data)!r}]))) == 3
ds = DatasetFactory().create_dataset("QueueDataset")
ds.set_batch_size(4)
ds.set_filelist([{str(data)!r}])
ds.set_use_var(slots)
assert train_from_dataset(lambda *a: a[2].sum(), ds, device="cpu") == [2.0]
os.environ.update(TRAINING_ROLE="PSERVER",
                  PADDLE_PSERVERS_IP_PORT_LIST="127.0.0.1:0")
fleet.init()
s = fleet.init_server({{"emb": (4, 2)}})
th = threading.Thread(target=fleet.run_server)
th.start()
c = PsClient([f"127.0.0.1:{{s.port}}"])
c.bye()
th.join(5)
assert not th.is_alive()
bad = [m for m in sys.modules if m.split(".")[0] in
       ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')
       and sys.modules[m] is not None]
print("ok" if not bad else bad)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_gpt_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert paddle_tpu_torch.get_device() == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        GPT(gpt_tiny(num_layers=1))
    with pytest.raises(RuntimeError, match="is_available"):
        tdevice.set_device("cuda")
    assert GPT(gpt_tiny(num_layers=1), device="cpu").wte.device.type == "cpu"


def test_gpt_pipeline_defaults_to_cuda(monkeypatch):
    """GPT on a mesh with pp > 1 lands on the card unless asked otherwise,
    and raises without it; on the CPU each rank holds its stage."""
    from paddle_tpu_torch.parallel import LoopbackWorld
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def fn(rank, mesh):
        with pytest.raises(RuntimeError, match="is_available"):
            GPT(gpt_tiny(num_layers=2), mesh=mesh)
        m = GPT(gpt_tiny(num_layers=2), device="cpu", mesh=mesh)
        return m.qkv_w.device.type, m.qkv_w.shape[0], m.qkv_w.pp_split
    assert LoopbackWorld(2).run(fn, axes={"pp": 2}) == [
        ("cpu", 1, (2, r)) for r in range(2)]


def test_tp_entry_points_default_to_cuda(monkeypatch):
    """The tensor-parallel layers land on the card unless asked otherwise,
    and raise without it."""
    from paddle_tpu_torch import distributed as tdist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda d: tdist.ColumnParallelLinear(4, 8, device=d),
                 lambda d: tdist.RowParallelLinear(4, 8, device=d),
                 lambda d: tdist.VocabParallelEmbedding(16, 4, device=d)):
        with pytest.raises(RuntimeError, match="is_available"):
            make(None)
        assert make("cpu").weight.device.type == "cpu"


def test_bert_mp_and_ps_entry_points_default_to_cuda(monkeypatch):
    """Bert at mp = 2, ShardedEmbedding, the rank models, the pulled rows
    of DistributedEmbedding, PSTrainStep, MeshShardedEmbedding and
    DeviceEmbeddingTrainStep land on the card unless asked otherwise, and
    raise without it; on the CPU Bert at mp = 2 holds its shards."""
    import numpy as np
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.models import (Bert, DeepFM, WideDeep,
                                         WideDeepHost, bert_tiny)
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import LoopbackWorld
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def fn(rank, mesh):
        with pytest.raises(RuntimeError, match="is_available"):
            Bert(bert_tiny(), mesh=mesh)
        m = Bert(bert_tiny(), device="cpu", mesh=mesh)
        return m.wte.device.type, tuple(m.wte.shape)
    assert LoopbackWorld(2).run(fn, axes={"mp": 2}) == [
        ("cpu", (128, 64))] * 2
    for make in (lambda d: ps.ShardedEmbedding(8, 2, device=d),
                 lambda d: WideDeep(16, 2, 2, 1, (4,), device=d),
                 lambda d: DeepFM(16, 2, 2, 1, (4,), device=d),
                 lambda d: WideDeepHost(2, 2, 1, (4,), device=d),
                 lambda d: ps.MeshShardedEmbedding(8, 2, device=d)):
        with pytest.raises(RuntimeError, match="is_available"):
            make(None)
        assert list(make("cpu").parameters())[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="is_available"):
        ps.DistributedEmbedding(8, 2)
    emb = ps.DistributedEmbedding(8, 2, device="cpu")
    assert emb(np.array([[1, 2]])).device.type == "cpu"
    model = WideDeepHost(1, 2, 1, (4,), device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        ps.PSTrainStep(model, None, SGD(), emb)
    assert ps.PSTrainStep(model, None, SGD(), emb,
                          device="cpu").device.type == "cpu"
    table = ps.MeshShardedEmbedding(8, 2, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        ps.DeviceEmbeddingTrainStep(model, None, SGD(), table)
    assert ps.DeviceEmbeddingTrainStep(model, None, SGD(), table,
                                       device="cpu").device.type == "cpu"


def test_fleet_init_and_init_parallel_env_default_to_cuda(monkeypatch):
    """fleet.init() and init_parallel_env() start their process group on
    the default device, the card, and raise without it (where a division
    by the count of cards once died) before any group is started; the
    reference's fleet.init runs on its own default device there."""
    import torch.distributed as tdist_

    import paddle_tpu.distributed.fleet as jfleet
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.distributed import fleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                "PADDLE_TRAINER_ENDPOINTS"):
        monkeypatch.delenv(var, raising=False)
    assert not tdist_.is_initialized()
    with pytest.raises(RuntimeError, match="is_available"):
        fleet.init()
    with pytest.raises(RuntimeError, match="is_available"):
        tdist.init_parallel_env()
    assert not tdist_.is_initialized()
    from paddle_tpu.parallel import get_mesh, set_mesh
    prev_mesh, prev_state = get_mesh(), dict(vars(jfleet._state))
    try:
        jfleet.init(is_collective=True)
        assert jfleet.worker_num() == 1
    finally:
        set_mesh(prev_mesh)
        vars(jfleet._state).clear()
        vars(jfleet._state).update(prev_state)


def test_seq2seq_entry_points_default_to_cuda(monkeypatch):
    """The causal mask and the recurrent layers land on the card unless
    asked otherwise, and raise without it."""
    import paddle_tpu_torch.nn as tnn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tnn.Transformer.generate_square_subsequent_mask(8)
    with pytest.raises(RuntimeError, match="is_available"):
        tnn.LSTM(4, 8)
    with pytest.raises(RuntimeError, match="is_available"):
        tnn.Embedding(10, 4)
    assert tnn.Transformer.generate_square_subsequent_mask(
        8, device="cpu").device.type == "cpu"
    assert tnn.LSTM(4, 8, device="cpu").weight_ih_l0.device.type == "cpu"


def test_eager_slice_entry_points_default_to_cuda(monkeypatch):
    """The layers that take a ParamAttr, the initializers, the parameter
    factory, MobileNet and VGG land on the card unless asked otherwise,
    and raise without it; amp.decorate keeps parameters where they are."""
    import paddle_tpu_torch.amp as tamp
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.nn.initializer as tinit
    from paddle_tpu_torch.vision.models import (mobilenet_v1, mobilenet_v2,
                                                vgg11)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tnn.PReLU(3), lambda: tnn.Conv2D(3, 4, 3),
                 lambda: tnn.Linear(3, 4, weight_attr=tnn.ParamAttr("w")),
                 lambda: tnn.BatchNorm2D(3), lambda: tnn.LayerNorm(3),
                 lambda: tinit.XavierUniform()((3, 4)),
                 lambda: tinit.Dirac()((3, 3, 3)),
                 lambda: tinit._create_param([3]),
                 lambda: mobilenet_v1(scale=0.25, num_classes=2),
                 lambda: mobilenet_v2(scale=0.25, num_classes=2),
                 lambda: vgg11(num_classes=2)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    lin = tamp.decorate(tnn.Linear(3, 4, device="cpu"), level="O2")
    assert lin.weight.device.type == "cpu"
    assert lin.weight.dtype == torch.bfloat16


def test_dense_nn_slice_entry_points_default_to_cuda(monkeypatch):
    """The transposed convolutions, Bilinear and the loss heads with
    parameters land on the card unless asked otherwise, and raise without
    it; the transforms stay on the host whatever the card."""
    import numpy as np

    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.vision.transforms as T
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tnn.Conv1DTranspose(3, 4, 3),
                 lambda: tnn.Conv2DTranspose(3, 4, 3),
                 lambda: tnn.Conv3DTranspose(3, 4, 3),
                 lambda: tnn.Bilinear(3, 4, 5),
                 lambda: tnn.HSigmoidLoss(4, 6),
                 lambda: tnn.NCELoss(10, 4)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert tnn.Conv2DTranspose(3, 4, 3, device="cpu").weight.shape == (
        3, 4, 3, 3)
    img = np.zeros((8, 8, 3), np.uint8)
    out = T.to_tensor(T.RandomResizedCrop(4)(img), out="tensor")
    assert out.device.type == "cpu" and tuple(out.shape) == (3, 4, 4)


def test_layer_slice_entry_points_default_to_cuda(monkeypatch):
    """GroupNorm, the instance norms, SpectralNorm, Embedding(sparse=True)
    and Layer.create_parameter land on the card unless asked otherwise,
    and raise without it; spectral_norm's vectors follow the wrapped
    weight."""
    import paddle_tpu_torch.nn as tnn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tnn.GroupNorm(2, 4),
                 lambda: tnn.InstanceNorm2D(4),
                 lambda: tnn.SpectralNorm([4, 3]),
                 lambda: tnn.Embedding(10, 4, sparse=True),
                 lambda: tnn.Layer().create_parameter([3])):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert tnn.Layer().create_parameter([3], device="cpu").device.type == (
        "cpu")
    conv = tnn.utils.spectral_norm(tnn.Conv2D(3, 4, 3, device="cpu"))
    assert conv.weight_spectral_norm.weight_u.device.type == "cpu"


def test_vision_ops_entry_points_default_to_cuda(monkeypatch):
    """DeformConv2D lands on the card unless asked otherwise and raises
    without it; the priors and anchors go to their input's device, and
    the ops compute where their inputs are."""
    from paddle_tpu_torch.vision import ops as tops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tops.DeformConv2D(4, 4, 3)
    assert tops.DeformConv2D(4, 4, 3, device="cpu").weight.device.type == (
        "cpu")
    img = torch.zeros(1, 3, 24, 32)
    for dev in ("cpu", "meta"):
        feat = torch.zeros(1, 2, 3, 4, device=dev)
        for made in (tops.prior_box(feat, img, [8.0]),
                     tops.anchor_generator(feat, [16.0], [1.0]),
                     tops.density_prior_box(feat, img, [2], [8.0], [1.0])):
            assert all(t.device.type == dev for t in made)
    feat = torch.zeros(1, 2, 3, 4)
    boxes = torch.tensor([[0.0, 0.0, 2.0, 2.0]])
    assert tops.roi_align(feat, boxes, None, 2).device.type == "cpu"


def test_fleet_recompute_runs_where_its_inputs_are(monkeypatch):
    """fleet.utils.recompute picks no device: a remat model still defaults
    to the card (and raises without it), and a block on CPU tensors
    recomputes on the CPU."""
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        GPT(gpt_tiny(num_layers=1, remat=True))
    x = torch.ones(2, 3, requires_grad=True)
    out = recompute(lambda t: (t * t).sum(), x)
    out.backward()
    assert out.device.type == "cpu" and torch.equal(x.grad, 2 * x.detach())


def test_set_device_round_trip():
    prev = paddle_tpu_torch.get_device()
    try:
        assert tdevice.set_device("cpu").type == "cpu"
        assert tdevice.resolve_device().type == "cpu"
    finally:
        tdevice._default = prev
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.resolve_device("meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_build_target_is_keyed_by_source_hash():
    for name in _build.KERNELS:
        t = _build._target(name)
        assert t.parent == _build.BUILD_DIR and t.name.startswith(name + "-")
        assert t == _build._target(name)            # stable
    assert (_build._target("flash_attention_fwd").name
            != _build._target("fused_ce_fwd").name)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_cuda():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_data_and_state_planes_run_with_jax_blocked(tmp_path):
    """A DataLoader through the ingest pipeline into an armed TrainStep,
    a committed generation saved and restored, in a process where jax,
    ml_dtypes and paddle_tpu cannot be imported."""
    code = f"""
import sys
for name in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'):
    sys.modules[name] = None
import numpy as np, torch
from paddle_tpu_torch import io
from paddle_tpu_torch.distributed.durable import CheckpointManager
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Adam
set_flags({{"numerics": True}})
x = np.arange(24, dtype=np.float32).reshape(8, 3)
ds = io.TensorDataset([x, x[:, :1]])
loader = io.DataLoader(ds, batch_size=4, collate_fn=io.numpy_collate)
step = TrainStep(torch.nn.Linear(3, 1), lambda m, a, b: ((m(a) - b) ** 2).mean(),
                 Adam(learning_rate=0.1))
for a, b in io.IngestPipeline(loader, device="cpu"):
    step(a, b)
assert step.last_numerics.finite()
mgr = CheckpointManager({str(tmp_path)!r})
mgr.save(step, 1)
fresh = TrainStep(torch.nn.Linear(3, 1), step.loss_fn, Adam(learning_rate=0.1))
assert mgr.restore(fresh) == 1
assert torch.equal(fresh.model.weight, step.model.weight)
assert not any(m in sys.modules and sys.modules[m] is not None
               for m in ('jax', 'paddle_tpu', 'ml_dtypes'))
print('ok')
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
