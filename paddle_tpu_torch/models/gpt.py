"""GPT — the flagship decoder-only LM (port of paddle_tpu/models/gpt.py).

Logits through :meth:`GPT.forward` and the causal-LM loss through
:func:`gpt_loss`, with the fused linear+CE head when ``FLAGS_gpt_fused_ce``
is set.  Both record on autograd's tape, as the reference's forward
records on its own: gradients flow through the flash kernels (S >= 128),
the dense fallback (S < 128) and the fused head's dh and dW kernels; the
tied ``wte`` receives the embedding's gradient and the head's, which
autograd sums.  Serving callers wrap their calls in
``torch.inference_mode()``.

What is the same as the reference: the configuration and presets, the
stacked (L, ...) parameters with the same names, shapes and numpy draws
(``np.random.default_rng(seed)`` in the same order), pre-LN layers with
tanh-GELU, the tied head, the loss conventions, and ``remat`` (the
default): each layer is one recompute region under autograd
(``jit/recompute.py``, the reference's ``jax.checkpoint(layer)``,
``:218``), its activations rebuilt in the backward, while the embedding,
the final LN and the head keep theirs.  ``bench.py``'s GPT-2 legs run
``remat=False``.  What differs: a Python loop over layers stands in for
``lax.scan`` (``scan_unroll`` is accepted and means nothing in eager
PyTorch).

Tensor and sequence parallelism (reference ``:115-140``, ``:155-194``,
``:246-274``).  Every parameter carries the reference's ``DistAttr``.
Built under an active mesh whose ``mp`` or ``sp`` axis has size > 1, or
given one by :meth:`GPT.apply_mesh` (``ShardedTrainStep`` does), a GPT
runs on it; where ``mp`` has size m > 1 it holds this rank's shards:
``wte`` by vocabulary range, ``qkv_w`` / ``qkv_b`` /
``fc_w`` / ``fc_b`` by output columns, ``prj_w`` / ``out_w`` by input
rows, the rest whole.  ``qkv``'s shard is head-aligned where the
reference's spec cuts the fused 3H axis contiguously: rank r holds heads
[r nh/m, (r + 1) nh/m) of q, of k and of v (GSPMD reshards the
contiguous cut before the head reshape; a hand-written program cannot),
and the converters (``models/convert.py``) permute the reference's layout
in and out.  ``num_heads``, the vocabulary and the FFN width must divide
by m.  On a rank at ``sp`` coordinate j of n the forward embeds the
rank's positions [j S/n, (j + 1) S/n) of the whole sequence it is given
(the vocabulary-parallel lookup, ``wpe`` at the rank's offset), attends
on its heads through ``ring_attention`` over ``sp`` when n > 1, sums
``prj`` and ``out`` over ``mp`` (row-parallel), and ends in the tied
head's (B, S/n, V/m) logit slice.  :meth:`GPT.forward` all-gathers the
full (B, S, V) logits; :func:`gpt_loss` is a vocabulary-parallel cross
entropy (``parallel.tp.vocab_parallel_ce``): no rank holds the (B, S, V)
logits; the next-token labels are shifted over the whole sequence (-1 on
the global last position, reference ``:299-301``), each rank takes its
slice, and the partial sums over ``sp`` divide by the global B (S - 1).
The mesh is read once a forward (a ``_Plan``); with no mesh, or one
whose ``mp`` and ``sp`` are 1, it is ``_ONE``, on which every collective
is the identity and the loss is the plain mean.
``FLAGS_gpt_fused_ce`` takes the fused head only where the mesh has one
rank (reference ``:377-378``).  ``remat=True`` at mp or sp > 1 replays the
collectives in the backward: it runs on the CPU and on one rank a
process, and raises on ``LoopbackWorld`` ranks on the card, where the
replay would meet them on autograd's one device thread.

The pipeline (reference ``:246-329``, ``:361-374``).  Under a mesh whose
``pp`` axis has size P > 1 a GPT holds only its stage's L/P layers of
each stacked parameter (``p.pp_split``, ``parallel.pipeline.shard_stage``;
``wte``, ``wpe`` and ``lnf_*`` whole on every stage), composed with the
mp shards.  The trunk runs through the pipeline in M =
max(``n_microbatches``, P) microbatches of the rank's batch, each stage's
layers on the mp and sp path above (the ring over ``sp`` inside a
stage).  ``schedule_mode`` 0 (F-then-B): ``GPT.forward`` and
:func:`gpt_loss` embed on every stage, run the trunk through
``pipeline_forward`` (every stage gets the last stage's output) and end
in the final LN and the tied head on every stage, so a replicated
parameter's gradient is the same on each (the embedding's from stage 0's
input gradient, which reaches every stage).  ``schedule_mode`` 1:
:func:`gpt_loss` is the 1F1B program (``make_pipeline_train_1f1b``) with
the reference's head on the last stage (final LN, f32 tied logits, the
vocabulary-parallel CE against the globally shifted labels, summed over
the rank's positions and divided by the global mb (S - 1)), the head's
gradient summed over ``pp``.  The data and sequence ranks' sums stay
``ShardedTrainStep``'s.  ``remat=True`` at pp > 1 runs where the mesh
has no mp or sp (a layer's replay holds no collective).

Attention dispatches by rule, not by catching errors: sequences the
blockwise kernel serves (``flash_attention.supported``: head dim 64 or
128, f32 or bf16) take it — the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor — and the rest (S < 128, f16, other head dims)
take the dense fallback.  The
reference wraps its kernel in ``try/except Exception: pass`` and falls
back silently; the port does not: a kernel that cannot run raises.

Mixed precision: ``model.to(torch.bfloat16)`` casts the parameters for
serving; training keeps f32 parameters and casts a copy per step
(``jit.TrainStep(amp_level="O2")``), or trains bf16 parameters eagerly
after ``amp.decorate(level="O2")``.  Activations then run in bf16 and the
loss casts logits to f32.  Under ``amp.auto_cast`` the forward is one op,
``gpt_forward``, in neither list (O1 runs it as it comes, O2 casts the
parameters at its boundary), as are ``gpt_loss`` over the logits and
``gpt_loss_fused``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp import _op_scope, amp_cast_for_op
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.parameter import Parameter
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.jit.recompute import recompute
from paddle_tpu_torch.nn.functional.attention import _xla_attention
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.ops.cuda import flash_attention as _fa
from paddle_tpu_torch.ops.cuda import fused_ce
from paddle_tpu_torch.parallel import pipeline, tp
from paddle_tpu_torch.parallel.mesh import (DistAttr, current_mesh,
                                            in_loopback,
                                            require_no_model_parallel)

__all__ = ["GPTConfig", "GPT", "gpt_loss", "gpt_tiny", "gpt2_small",
           "gpt2_medium", "gpt2_345m"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=1024, num_layers=24,
                 num_heads=16, ffn_size: Optional[int] = None,
                 max_seq_len=1024, initializer_range=0.02,
                 remat: bool = True, n_microbatches: int = 1,
                 use_flash_attention: bool = True, seed: int = 0,
                 schedule_mode: int = 0, scan_unroll: int = 1):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.initializer_range = initializer_range
        # recompute each layer in the backward (jit/recompute.py)
        self.remat = remat
        # the pipeline's microbatches (max(n_microbatches, pp)) and its
        # schedule (0 F-then-B, 1 1F1B) under a mesh with pp > 1
        self.n_microbatches = n_microbatches
        self.use_flash_attention = use_flash_attention
        self.seed = seed
        self.schedule_mode = schedule_mode
        self.scan_unroll = scan_unroll

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def gpt_tiny(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 4)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_seq_len", 128)
    return GPTConfig(**kw)


def gpt2_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt2_medium(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


# "GPT-2 345M" — the flagship configuration
gpt2_345m = gpt2_medium


# fixed parameter order (the reference's pure-forward argument order)
_PARAM_ORDER = ("wte", "wpe", "ln1_w", "ln1_b", "qkv_w", "qkv_b", "prj_w",
                "prj_b", "ln2_w", "ln2_b", "fc_w", "fc_b", "out_w", "out_b",
                "lnf_w", "lnf_b")
_LAYER_PARAMS = _PARAM_ORDER[2:14]
# the parameters a pipeline stage holds its layers of (leading dim L)
STAGE_SPLIT = frozenset(_LAYER_PARAMS)

# the reference's annotations (gpt.py:122-140)
DIST_ATTRS = {"wte": ("mp", None), "ln1_w": ("pp",), "ln1_b": ("pp",),
              "qkv_w": ("pp", None, "mp"), "qkv_b": ("pp", "mp"),
              "prj_w": ("pp", "mp", None), "prj_b": ("pp",),
              "ln2_w": ("pp",), "ln2_b": ("pp",), "fc_w": ("pp", None, "mp"),
              "fc_b": ("pp", "mp"), "out_w": ("pp", "mp", None),
              "out_b": ("pp",)}
# how the port cuts each mp-split parameter: qkv head-aligned (three
# blocks, q / k / v), the rest contiguously
MP_SPLITS = {"wte": tp.Split(0), "qkv_w": tp.Split(2, 3),
             "qkv_b": tp.Split(1, 3), "fc_w": tp.Split(2),
             "fc_b": tp.Split(1), "prj_w": tp.Split(1), "out_w": tp.Split(1)}


class _Plan(NamedTuple):
    """One forward's view of the mesh: the ``mp``, ``sp`` and ``pp``
    groups (None where the axis has size 1), this rank's place on each,
    and the mesh."""
    mp: int
    mp_rank: int
    mp_group: object
    sp: int
    sp_rank: int
    sp_group: object
    pp: int = 1
    pp_rank: int = 0
    pp_group: object = None
    mesh: object = None


_ONE = _Plan(1, 0, None, 1, 0, None)                  # no mesh, one rank


def init_params(c: GPTConfig) -> dict:
    """The reference's initial parameters as numpy arrays: the same
    ``default_rng(seed)`` draws in the same order (gpt.py:107-140)."""
    rng = np.random.default_rng(c.seed)
    std = c.initializer_range
    L, H, F_, V, S = (c.num_layers, c.hidden_size, c.ffn_size,
                      c.vocab_size, c.max_seq_len)

    def norm(shape, scale=std):
        return rng.standard_normal(shape).astype(np.float32) * scale

    p = {}
    p["wte"] = norm((V, H))
    p["wpe"] = norm((S, H))
    p["ln1_w"] = np.ones((L, H), np.float32)
    p["ln1_b"] = np.zeros((L, H), np.float32)
    p["qkv_w"] = norm((L, H, 3 * H))
    p["qkv_b"] = np.zeros((L, 3 * H), np.float32)
    # GPT-2 residual-projection scaling: std/sqrt(2L)
    p["prj_w"] = norm((L, H, H), std / math.sqrt(2 * L))
    p["prj_b"] = np.zeros((L, H), np.float32)
    p["ln2_w"] = np.ones((L, H), np.float32)
    p["ln2_b"] = np.zeros((L, H), np.float32)
    p["fc_w"] = norm((L, H, F_))
    p["fc_b"] = np.zeros((L, F_), np.float32)
    p["out_w"] = norm((L, F_, H), std / math.sqrt(2 * L))
    p["out_b"] = np.zeros((L, H), np.float32)
    p["lnf_w"] = np.ones((H,), np.float32)
    p["lnf_b"] = np.zeros((H,), np.float32)
    return p


class GPT(Layer):
    # on a mesh with sp > 1 each rank runs its positions of the sequence
    # (ShardedTrainStep sums its gradients over sp)
    splits_sequence = True

    def __init__(self, config: GPTConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        for name, value in init_params(config).items():
            p = Parameter(torch.from_numpy(value).to(dev), name=f"gpt.{name}")
            if name in DIST_ATTRS:
                p.dist_attr = DistAttr(DIST_ATTRS[name])
            self.register_parameter(name, p)
        self._mesh = None
        self._mp = self._pp = 1
        mesh = mesh if mesh is not None else current_mesh()
        if mesh is not None and any(mesh.shape.get(a, 1) > 1
                                    for a in ("mp", "sp", "pp")):
            self.apply_mesh(mesh)

    def apply_mesh(self, mesh) -> "GPT":
        """Run on ``mesh`` from now on: where its ``pp`` axis has size
        P > 1, hold this rank's stage of the stacked parameters, and where
        its ``mp`` axis has size m > 1, this rank's shards (each once; a
        second mesh must have the same P and m).  ``ep`` raises."""
        require_no_model_parallel(mesh, "GPT")
        c = self.config
        m = mesh.shape.get("mp", 1)
        if m != self._mp and self._mp != 1:
            raise ValueError(f"GPT holds {self._mp} mp shards; the mesh has "
                             f"mp={m}")
        P = mesh.shape.get("pp", 1)
        if P != self._pp and self._pp != 1:
            raise ValueError(f"GPT holds one of {self._pp} pipeline stages; "
                             f"the mesh has pp={P}")
        if P > 1 and self._pp == 1:
            if c.num_layers % P:
                raise ValueError(f"GPT at pp={P}: num_layers={c.num_layers} "
                                 f"does not divide by {P}")
            stage = mesh.axis_index("pp")
            for name in _LAYER_PARAMS:
                pipeline.shard_stage(getattr(self, name), P, stage)
            self._pp = P
        if m > 1 and self._mp == 1:
            for what, size in (("num_heads", c.num_heads),
                               ("vocab_size", c.vocab_size),
                               ("ffn_size", c.ffn_size)):
                if size % m:
                    raise ValueError(f"GPT at mp={m}: {what}={size} does not "
                                     f"divide by {m}")
            idx = mesh.axis_index("mp")
            for name, split in MP_SPLITS.items():
                tp.shard_parameter(getattr(self, name), split, m, idx)
            self._mp = m
        s = mesh.shape.get("sp", 1)
        if s > 1 and c.max_seq_len % s:
            raise ValueError(f"GPT at sp={s}: max_seq_len={c.max_seq_len} "
                             f"does not divide by {s}")
        self._mesh = mesh
        return self

    def _plan(self) -> _Plan:
        """The mesh read once a forward: ``_ONE`` where mp = sp = pp = 1."""
        mesh = self._mesh if self._mesh is not None else current_mesh()
        if mesh is None:
            return _ONE
        m, s, P = (mesh.shape.get(a, 1) for a in ("mp", "sp", "pp"))
        if m == 1 and s == 1 and P == 1:
            return _ONE
        if m != self._mp or P != self._pp:
            raise ValueError(f"GPT holds {self._mp} mp shards and one of "
                             f"{self._pp} stages; the mesh has mp={m}, "
                             f"pp={P}: build it under the mesh or call "
                             "apply_mesh")
        require_no_model_parallel(mesh, "GPT")

        def place(axis, size):
            return ((mesh.axis_index(axis), mesh.axis_group(axis))
                    if size > 1 else (0, None))
        return _Plan(m, *place("mp", m), s, *place("sp", s), P,
                     *place("pp", P), mesh)

    def load_jax_params(self, np_params: dict) -> "GPT":
        """Copy the reference model's parameters in (``np.asarray`` of
        each ``model._parameters[n]._data``), keyed by ``_PARAM_ORDER``;
        a sharded GPT takes its shards of them."""
        from paddle_tpu_torch.models.convert import params_from_jax
        with torch.no_grad():
            for name, t in params_from_jax(np_params).items():
                p = getattr(self, name)
                t = pipeline.stage_slice(t, p)
                split = getattr(p, "mp_split", None)
                if split is not None:
                    t = split[0].take(t, *split[1:])
                if p.shape != t.shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)} does "
                                     f"not match {tuple(p.shape)}")
                p.copy_(t)
        return self

    def forward(self, input_ids) -> torch.Tensor:
        """input_ids (B, S) int -> logits (B, S, V).  One op for
        ``amp.auto_cast``, as the reference's ``gpt_forward``.  Under mp or
        sp > 1 every rank returns the full logits (all-gathered)."""
        ids = self._ids(input_ids)
        plan = self._plan()
        params = amp_cast_for_op("gpt_forward", self._param_list())
        with _op_scope():
            lg = _gpt_forward(self.config, dict(zip(_PARAM_ORDER, params)),
                              ids, plan=plan)
            return tp.gather(tp.gather(lg, plan.mp_group, -1),
                             plan.sp_group, 1)

    def _param_list(self) -> list:
        return [getattr(self, n) for n in _PARAM_ORDER]

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, device=self.wte.device).long()


def _ln(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _attention(cfg: GPTConfig, q, k, v, plan: _Plan):
    """(B, S, nh, hd) causal attention: the ring over ``sp`` where the
    sequence is split, else the blockwise kernel where the reference's
    rule sends it, else the dense fallback."""
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if plan.sp > 1:
        from paddle_tpu_torch.parallel.ring_attention import _ring
        return _ring(q, k, v, True, scale, plan.sp_group)
    if cfg.use_flash_attention and _fa.supported(
            tuple(q.shape), tuple(k.shape), causal=True, dtype=q.dtype):
        return _fa.flash_attention(q, k, v, causal=True, scale=scale)
    return _xla_attention(q, k, v, None, scale, True)


def _layer(cfg: GPTConfig, x, lp, plan: _Plan):
    """One block on this rank's heads and FFN columns: the column-split
    products take the replicated input through ``tp.copy_to``, the
    row-split ones sum over ``mp`` before the replicated bias (each the
    identity on one rank)."""
    b, s = x.shape[:2]
    nh, hd = cfg.num_heads // plan.mp, cfg.head_dim
    g = plan.mp_group
    h = tp.copy_to(_ln(x, lp["ln1_w"], lp["ln1_b"]), g)
    qkv = h @ lp["qkv_w"] + lp["qkv_b"]                 # (b,s,3H/m)
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(nh * hd, dim=-1))
    a = _attention(cfg, q, k, v, plan).reshape(b, s, nh * hd)
    x = x + tp.reduce(a @ lp["prj_w"], g) + lp["prj_b"]
    h2 = tp.copy_to(_ln(x, lp["ln2_w"], lp["ln2_b"]), g)
    ff = F.gelu(h2 @ lp["fc_w"] + lp["fc_b"], approximate="tanh")
    return x + tp.reduce(ff @ lp["out_w"], g) + lp["out_b"]


def _positions(plan: _Plan, s: int):
    """This rank's slice [off, off + s/n) of a sequence of s positions."""
    if s % plan.sp:
        raise ValueError(f"sequence {s} does not divide over sp={plan.sp}")
    w = s // plan.sp
    return plan.sp_rank * w, w


def _embed(p: dict, ids, plan: _Plan):
    """ids (B, S) the whole sequence -> this rank's (B, S/n, H) embedding
    of its positions (the vocabulary-parallel lookup at mp > 1)."""
    off, w = _positions(plan, ids.shape[1])
    ids = ids[:, off:off + w]
    if plan.mp > 1:
        from paddle_tpu_torch.distributed.tp_layers import vocab_lookup
        x = vocab_lookup(p["wte"], ids, plan.mp_group)
    else:
        # F.embedding, not wte[ids]: its CPU backward adds each row's
        # gradients in index order, where index_put_'s sums in thread
        # order, and every pp stage must compute the same wte gradient
        x = F.embedding(ids, p["wte"])
    return x + p["wpe"][off:off + w][None, :, :]


def _stage(cfg: GPTConfig, plan: _Plan, stacked: dict, x):
    """The trunk's layers held in ``stacked`` ({name: (L', ...)}, this
    stage's at pp > 1) over x, each one recompute region with remat."""
    if cfg.remat and (plan.mp > 1 or plan.sp > 1) and \
            torch.is_grad_enabled() and in_loopback() and x.is_cuda:
        # the replay would meet the collectives on autograd's one device
        # thread, where one rank's wait blocks the other's
        raise NotImplementedError(
            "GPT(remat=True) at mp or sp > 1 on LoopbackWorld ranks on the "
            "card: build it with remat=False, or run one rank a process")
    # one unbind per stacked parameter: its backward is one stack, where
    # indexing each layer would sum L full-size gradients per parameter
    per_layer = {n: stacked[n].unbind(0) for n in _LAYER_PARAMS}
    layer = functools.partial(recompute, _layer) if cfg.remat else _layer
    for i in range(stacked["ln1_w"].shape[0]):
        x = layer(cfg, x, {n: per_layer[n][i] for n in _LAYER_PARAMS}, plan)
    return x


def _n_micro(cfg: GPTConfig, plan: _Plan) -> int:
    """The pipeline's M (reference ``:264``, ``:308``)."""
    return max(cfg.n_microbatches, plan.pp)


def _gpt_forward(cfg: GPTConfig, p: dict, ids, features_only: bool = False,
                 plan: _Plan = _ONE):
    """The forward over the parameters ``p`` ({name in _PARAM_ORDER:
    tensor}, the stacked ones this rank's stage at pp > 1) on one rank of
    a pp x mp x sp mesh (``plan``): ids (B, S) the whole sequence -> this
    rank's (B, S/n, V/m) logits (or its (B, S/n, H) final hidden
    states)."""
    x = _embed(p, ids, plan)
    stacked = {n: p[n] for n in _LAYER_PARAMS}
    stage = functools.partial(_stage, cfg, plan)
    if plan.pp > 1:
        x = pipeline.pipeline_forward(stage, stacked, x,
                                      _n_micro(cfg, plan),
                                      mesh=plan.mesh)
    else:
        x = stage(stacked, x)
    x = _ln(x, p["lnf_w"], p["lnf_b"])
    if features_only:
        return x
    return tp.copy_to(x, plan.mp_group) @ p["wte"].T   # tied head


def _shifted(labels, plan: _Plan):
    """The next-token labels (-1 on the global last position, reference
    ``:299-301``), this rank's positions."""
    B, S = labels.shape
    off, w = _positions(plan, S)
    lab = torch.cat([labels[:, 1:], labels.new_full((B, 1), -1)], dim=1)
    return lab[:, off:off + w]


def _ce_sum(lg, lab, plan: _Plan, denominator: int):
    """The vocabulary-parallel CE of this rank's (b, s, V/m) logits in f32
    against ``lab`` (b, s), summed where lab >= 0, over ``denominator``."""
    lab = lab.reshape(-1)
    per = tp.vocab_parallel_ce(lg.float().reshape(lab.shape[0], -1), lab,
                               plan.mp_rank * lg.shape[-1], plan.mp_group)
    return torch.where(lab >= 0, per, torch.zeros_like(per)).sum() / \
        denominator


def _gpt_1f1b_loss(cfg: GPTConfig, p: dict, ids, labels, plan: _Plan):
    """The loss under schedule_mode 1 at pp > 1 (reference ``:277-329``):
    the embedding on every stage, the trunk and the head through the 1F1B
    program, the head on the last stage at B time (final LN, f32 tied
    logits, the vocabulary-parallel CE, summed over the rank's positions
    over the global mb (S - 1)); summed over ``sp``."""
    S = labels.shape[1]
    x = _embed(p, ids, plan)

    def head_loss(hp, y, lab):
        h = _ln(y, hp["lnf_w"], hp["lnf_b"])
        lg = tp.copy_to(h, plan.mp_group) @ hp["wte"].T
        return _ce_sum(lg, lab, plan, y.shape[0] * (S - 1))
    fn = pipeline.make_pipeline_train_1f1b(
        functools.partial(_stage, cfg, plan), head_loss,
        _n_micro(cfg, plan), mesh=plan.mesh, data_axes=())
    loss = fn({n: p[n] for n in _LAYER_PARAMS},
              {n: p[n] for n in ("wte", "lnf_w", "lnf_b")}, x,
              _shifted(labels, plan))
    return tp.reduce(loss, plan.sp_group)


def _gpt_loss_tp(lg, labels, plan: _Plan):
    """The causal-LM loss at mp, sp or pp > 1: the vocabulary-parallel CE
    of this rank's logits (B, S/n, V/m) against its slice of the globally
    shifted labels (B, S), the partial sums over ``sp`` divided by the
    global B (S - 1)."""
    B, S = labels.shape
    part = _ce_sum(lg, _shifted(labels, plan), plan, B * (S - 1))
    return tp.reduce(part, plan.sp_group)


def _gpt_fused_ce_loss(cfg: GPTConfig, p: dict, ids, labels):
    """Forward to the final LN, then the fused linear+CE head against the
    tied embedding (reference ``:335-353``)."""
    B, S = ids.shape
    h = _gpt_forward(cfg, p, ids, features_only=True)  # (B,S,H)
    # next-token labels with a -1 sentinel on the final position
    lab = torch.cat([labels[:, 1:], labels.new_full((B, 1), -1)], dim=1)
    lab_flat = lab.reshape(B * S)
    loss_n = fused_ce.fused_linear_cross_entropy(
        h.reshape(B * S, h.shape[-1]), p["wte"], lab_flat)
    w = (lab_flat >= 0).float()
    return (loss_n * w).sum() / (B * (S - 1))


def gpt_loss(model: GPT, input_ids, labels):
    """Causal-LM cross entropy (f32 softmax); labels == input tokens,
    shifted internally.  Under pp > 1 with ``schedule_mode`` 1 the trunk,
    head and loss run as the 1F1B program.  With ``FLAGS_gpt_fused_ce``
    the head and CE run as the fused kernel where its rule takes the head
    (``fused_ce.supported``: f32 or bf16), and the (B, S, V) logits are
    never materialised."""
    cfg = model.config
    ids, labels = model._ids(input_ids), model._ids(labels)
    B, S = ids.shape
    plan = model._plan()
    if plan.pp > 1 and cfg.schedule_mode == 1:
        params = amp_cast_for_op("gpt_loss_1f1b", model._param_list())
        with _op_scope():
            return _gpt_1f1b_loss(cfg, dict(zip(_PARAM_ORDER, params)), ids,
                                  labels, plan)
    if plan is not _ONE:
        # the (B, S, V) logits are on no rank: the vocabulary-parallel CE
        params = amp_cast_for_op("gpt_forward", model._param_list())
        with _op_scope():
            lg = _gpt_forward(cfg, dict(zip(_PARAM_ORDER, params)), ids,
                              plan=plan)
        (lg,) = amp_cast_for_op("gpt_loss", [lg])
        with _op_scope():
            return _gpt_loss_tp(lg, labels, plan)
    mesh = current_mesh()
    if flag("gpt_fused_ce") and (mesh is None or mesh.size == 1) and \
            fused_ce.supported(B * S, cfg.hidden_size, model.wte.dtype):
        params = amp_cast_for_op("gpt_loss_fused", model._param_list())
        with _op_scope():
            return _gpt_fused_ce_loss(
                cfg, dict(zip(_PARAM_ORDER, params)), ids, labels)
    (logits,) = amp_cast_for_op("gpt_loss", [model(ids)])
    lg = logits[:, :-1].float()
    tg = labels[:, 1:]
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, tg[..., None])[..., 0]
    return (logz - gold).mean()
