"""Pipeline parallelism: the microbatch schedules over a ``pp`` mesh axis
(port of paddle_tpu/parallel/pipeline.py :95-625; the reference's
PipelineOptimizer + SectionWorker, schedule_mode 0 = F-then-B, 1 = 1F1B).

The reference writes the schedule as one SPMD program: a ``lax.scan``
over clock ticks inside ``shard_map``, ``ppermute`` the send / receive
pair, the backward of F-then-B taken by autodiff through the scan and
1F1B's hand-interleaved under a ``custom_vjp``.  The port's ranks are
processes (or ``LoopbackWorld`` threads), so each rank runs its own
stage's timetable in Python, and a stage boundary is a
``send`` / ``recv`` between the two ranks of one ``pp`` group
(``parallel/mesh.py``).  Layout, on every rank:

- ``stacked_params``: a pytree of this rank's stage slice, leaves of
  leading dim L/P (stage s holds layers [s L/P, (s + 1) L/P) of the
  stacked (L, ...) parameters, what the reference's ``shard_map`` hands
  its body); at P = 1 the whole stack;
- ``stage_fn(local_params, x) -> y``, shape- and dtype-preserving;
- ``x``: this rank's batch (B, ...): each data group runs its own
  pipeline, and with a ``seq_axis`` the rank's sequence shard in dim 1
  (the stage function runs the ring over it).

**F-then-B** (:func:`pipeline_forward`) runs the M microbatches through
the stage, receiving each input from the previous stage and sending each
output to the next, keeps each microbatch's autograd graph, and returns
the last stage's (B, ...) output on every stage of the group (a sum over
``pp`` in rank order, the others' zeros: the same bits everywhere).  Its
backward, one ``torch.autograd.Function``, walks the microbatches in
reverse: the last stage seeds each with its slice of the output's
gradient, the others with the gradient received from the next stage;
each sends its input's gradient to the previous stage, and stage 0's
input gradient reaches every stage (a sum over ``pp``), so a replicated
embedding before the pipeline gets the same gradient on each.

**1F1B** (:func:`make_pipeline_train_1f1b`) runs the reference's
timetable (``_f_sched`` / ``_b_sched``): stage s runs F(m) at t = s + m
in the warm-up and t = 2m + s in steady state, B(m) at
t = 2P - 1 - s + 2m; the last stage runs the head and the loss at B time.
Each in-flight microbatch keeps its autograd graph from its F op to its
B op (at most P - s on stage s), where the reference recomputes the stage
forward at B time because JAX's vjp needs it: the same O(P mb)
activation memory, independent of M.  The gradients are computed inside
the schedule and handed out by a ``torch.autograd.Function``, so
``loss.backward()`` and ``TrainStep`` compose with it as with the
reference's ``custom_vjp``; the normalisations are the reference's
``finalize`` (:319-351).  The reference's two schedulers (cond-based and
masked) differ only in wasted work: the port has one, ``unconditional``
is accepted and changes nothing (with a ``seq_axis`` ``False`` still
raises, as there).

**Threads on the card.** On ``LoopbackWorld`` ranks autograd runs every
backward node whose gradients lie on the card on its one device thread,
shared by all ranks (``parallel/tp.py``).  So no send, receive or sum
over ranks runs inside a node that thread would take: 1F1B's run in its
forward, on the rank's own thread (each microbatch's backward is a
``torch.autograd.grad`` called from there), and F-then-B hands its
output over on the host where ``tp.needs_hop`` says so (the bytes count
in ``tp.host_bytes``), so its backward node runs on the rank's thread.

:func:`live_graphs` / :func:`peak_live_graphs` count the microbatch
graphs this rank (thread) holds: at most P under 1F1B, M under F-then-B.
Sends are ``isend``: a rank never waits on its own send, so two stages
sending to each other in one tick (1F1B's steady state) do not block.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from paddle_tpu_torch.parallel import tp
from paddle_tpu_torch.parallel.mesh import get_mesh, mean_over, sum_over

__all__ = ["pipeline_forward", "make_pipeline_train_1f1b", "live_graphs",
           "peak_live_graphs", "reset_live_graphs", "shard_stage",
           "stage_part", "stage_slice", "full_stages"]


# -- the live microbatch graphs of this rank ---------------------------------
_LOCAL = threading.local()


def live_graphs() -> int:
    """Microbatch graphs this thread (rank) holds now."""
    return getattr(_LOCAL, "live", 0)


def peak_live_graphs() -> int:
    """The most microbatch graphs this thread held at once since the last
    :func:`reset_live_graphs`."""
    return getattr(_LOCAL, "peak", 0)


def reset_live_graphs():
    _LOCAL.live = 0
    _LOCAL.peak = 0


def _hold(n: int):
    _LOCAL.live = live_graphs() + n
    _LOCAL.peak = max(peak_live_graphs(), _LOCAL.live)


# -- the stage slice of a stacked parameter ----------------------------------
def stage_part(t: torch.Tensor, n: int, stage: int) -> torch.Tensor:
    """Stage ``stage``'s part of ``t``'s n equal parts along dim 0 (a
    view)."""
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not split into "
                         f"{n} stages")
    w = t.shape[0] // n
    return t.narrow(0, stage * w, w)


def shard_stage(p: torch.nn.Parameter, n: int, stage: int):
    """Replace ``p``'s data by stage ``stage``'s part (in place, the same
    Parameter) and mark it ``p.pp_split = (n, stage)``."""
    with torch.no_grad():
        p.data = stage_part(p.data, n, stage).clone()
    p.pp_split = (n, stage)
    return p


def stage_slice(t: torch.Tensor, p) -> torch.Tensor:
    """The part of a whole stacked tensor ``t`` that the stage holding
    ``p`` keeps (t itself where p is not split over stages)."""
    split = getattr(p, "pp_split", None)
    return t if split is None else stage_part(t, *split)


def full_stages(module: torch.nn.Module, tensors: dict, group) -> dict:
    """{name: tensor} of ``module``'s parameters with each stage-split one
    all-gathered over ``group`` (its ``pp`` ranks) and concatenated in
    stage order; every rank of the group calls it."""
    out = dict(tensors)
    for name, p in module.named_parameters():
        if getattr(p, "pp_split", None) is not None and name in out:
            out[name] = torch.cat(list(group.all_gather(
                out[name].contiguous()).unbind(0)), 0)
    return out


# -- the sends and receives --------------------------------------------------
def _send(group, t: torch.Tensor, dst: int, pending: list):
    """``isend`` of t, kept alive in ``pending`` until :func:`_wait`."""
    t = t.detach().contiguous()
    pending.append((group.isend(t, dst), t))


def _send_back(group, g: torch.Tensor, dst: int, pending: list):
    """A stage's input gradient to the previous stage."""
    _send(group, g, dst, pending)


def _recv(group, like: torch.Tensor, src: int) -> torch.Tensor:
    return group.recv(torch.empty_like(like), src)


def _wait(pending: list):
    for work, _ in pending:
        if work is not None:
            work.wait()
    pending.clear()


def _microbatches(t: torch.Tensor, m: int) -> torch.Tensor:
    if t.shape[0] % m:
        raise ValueError(
            f"local batch {t.shape[0]} not divisible by {m} microbatches")
    return t.reshape((m, t.shape[0] // m) + tuple(t.shape[1:]))


def _trainable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# -- F-then-B ----------------------------------------------------------------
def _forward_run(stage_fn, tree, x, n_micro, group, keep):
    """The stage's M forwards in order: the (M, mb, ...) output of the
    last stage (zeros elsewhere) and, with ``keep``, each microbatch's
    (input, output) graph."""
    stage, n = group.rank, group.size
    xs = _microbatches(x, n_micro)
    graphs, outs, pending = [], [], []
    for m in range(n_micro):
        inp = xs[m] if stage == 0 else _recv(group, xs[m], stage - 1)
        if keep:
            inp = inp.detach().requires_grad_(stage > 0 or x.requires_grad)
            with torch.enable_grad():
                y = stage_fn(tree, inp)
            graphs.append((inp, y))
            _hold(1)
        else:
            y = stage_fn(tree, inp)
        if stage < n - 1:
            _send(group, y, stage + 1, pending)
        else:
            outs.append(y.detach())
    _wait(pending)
    out = torch.stack(outs) if stage == n - 1 else torch.zeros_like(xs)
    return sum_over(group, out).reshape(x.shape), graphs


class _FThenB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, spec, group, n_micro, hop, x, *leaves):
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        y, graphs = _forward_run(stage_fn, tree_unflatten(params, spec), x,
                                 n_micro, group, keep=True)
        ctx.graphs, ctx.params, ctx.group = graphs, params, group
        ctx.hop, ctx.device, ctx.x_grad = hop, x.device, x.requires_grad
        return tp._out(y, hop) if hop else y

    @staticmethod
    def backward(ctx, dy):
        group, graphs, params = ctx.group, ctx.graphs, ctx.params
        stage, n = group.rank, group.size
        dys = _microbatches(tp._back(dy, ctx.device, ctx.hop).contiguous(),
                            len(graphs))
        want = [p for p in params if p.requires_grad]
        acc = [None] * len(want)
        dx = torch.zeros_like(dys) if stage == 0 else None
        pending = []
        for m in reversed(range(len(graphs))):
            inp, y = graphs[m]
            seed = dys[m] if stage == n - 1 else _recv(group, y, stage + 1)
            needs = want + ([inp] if inp.requires_grad else [])
            gs = torch.autograd.grad(y, needs, seed, allow_unused=True)
            graphs[m] = None
            _hold(-1)
            for i in range(len(want)):
                g = gs[i] if gs[i] is not None else torch.zeros_like(want[i])
                acc[i] = g if acc[i] is None else acc[i] + g
            if stage > 0:
                _send_back(group, gs[-1], stage - 1, pending)
            elif inp.requires_grad:
                dx[m] = gs[-1]
        _wait(pending)
        ctx.graphs = None
        dx_out = None
        if ctx.x_grad:
            dx_out = sum_over(group, dx if dx is not None
                              else torch.zeros_like(dys)).reshape(dy.shape)
        it = iter(acc)
        grads = [next(it) if p.requires_grad else None for p in params]
        return (None, None, None, None, None, dx_out, *grads)


def pipeline_forward(stage_fn: Callable, stacked_params, x,
                     n_microbatches: int, mesh=None, pp_axis: str = "pp",
                     data_axes=("dp",), seq_axis: Optional[str] = None):
    """``x`` (this rank's batch) through the stages of the ``pp_axis``
    group, F-then-B (schedule_mode 0, reference ``:95-170``): the last
    stage's output, the same (B, ...) on every stage of the group.  At
    pp = 1 it is ``stage_fn(stacked_params, x)``.  Differentiable: the
    backward runs the stages in reverse, each sending its input's gradient
    to the previous stage.  ``data_axes`` and ``seq_axis`` are accepted
    for the reference's signature: each rank already holds its rows and
    positions, and the stage function runs the ring over ``seq_axis``."""
    mesh = mesh or get_mesh()
    if mesh.shape.get(pp_axis, 1) <= 1:
        return stage_fn(stacked_params, x)
    group = mesh.axis_group(pp_axis)
    leaves, spec = tree_flatten(stacked_params)
    if _trainable(x) or any(_trainable(p) for p in leaves):
        hop = tp.needs_hop(x, *leaves)
        y = _FThenB.apply(stage_fn, spec, group, int(n_microbatches), hop, x,
                          *leaves)
        return y.to(x.device) if hop else y
    with torch.no_grad():
        return _forward_run(stage_fn, stacked_params, x, int(n_microbatches),
                            group, keep=False)[0]


# -- 1F1B --------------------------------------------------------------------
def _f_sched(stage: int, t: int, n_stages: int, n_micro: int):
    """1F1B forward timetable: stage s runs F(m) at t = s + m during the
    warm-up (m < P - 1 - s) and at t = 2m + s in steady state.  Returns
    (m, valid)."""
    warm_m = t - stage
    if 0 <= warm_m < min(n_stages - 1 - stage, n_micro):
        return warm_m, True
    rel = t - stage
    m = rel // 2
    ok = rel >= 0 and rel % 2 == 0 and n_stages - 1 - stage <= m < n_micro
    return m, ok


def _b_sched(stage: int, t: int, n_stages: int, n_micro: int):
    """1F1B backward timetable: stage s runs B(m) at t = 2P - 1 - s + 2m."""
    rel = t - (2 * n_stages - 1 - stage)
    m = rel // 2
    return m, rel >= 0 and rel % 2 == 0 and m < n_micro


class _OneFOneB(torch.autograd.Function):
    """The schedule in the forward: (loss) with the gradients of x, the
    stage's and the head's parameters saved for the backward, which only
    scales them by the loss's gradient."""

    @staticmethod
    def forward(ctx, run, spec, x, labels, *leaves):
        loss, grads, dx = run(spec, x, labels, leaves)
        ctx.grads, ctx.dx = grads, dx
        return loss

    @staticmethod
    def backward(ctx, g):
        dx = None if ctx.dx is None else ctx.dx * g.to(ctx.dx.dtype)
        grads = [None if t is None else t * g.to(t.dtype) for t in ctx.grads]
        ctx.grads = ctx.dx = None
        return (None, None, dx, None, *grads)


def make_pipeline_train_1f1b(stage_fn: Callable, head_loss_fn: Callable,
                             n_microbatches: int, mesh=None,
                             pp_axis: str = "pp", data_axes=("dp",),
                             seq_axis: Optional[str] = None,
                             unconditional: Optional[bool] = None):
    """``loss_fn(stacked_params, head_params, x, labels)``: the 1F1B
    pipelined loss (schedule_mode 1, reference ``:200-625``), a scalar.

    ``head_loss_fn(head_params, y, labels)`` is one microbatch's loss,
    run on the last stage at B time (under ``seq_axis``: the local sum
    over the rank's positions divided by the global denominator).  The
    loss is the mean over the data ranks and the M microbatches; the
    head's gradient is summed over ``pp`` (the last stage's), under
    ``seq_axis`` the loss and every gradient summed over it; x's gradient
    is stage 0's on every stage, scaled by 1 / (M dp); labels get none.
    Without a grad (evaluation) it is :func:`pipeline_forward` followed by
    the head; with no pipeline axis and no data or sequence axis, the
    dense composition (reference ``:305-311``)."""
    mesh = mesh or get_mesh()
    n_stages = mesh.shape.get(pp_axis, 1)
    n_micro = int(n_microbatches)
    data = tuple(a for a in data_axes if mesh.shape.get(a, 1) > 1)
    seq = seq_axis if (seq_axis and mesh.shape.get(seq_axis, 1) > 1) \
        else None
    if unconditional is False and seq is not None:
        raise ValueError(
            "make_pipeline_train_1f1b: the cond-based scheduler "
            "(unconditional=False) cannot carry a seq_axis — in-stage ring "
            "collectives inside divergent lax.cond branches mispair "
            "collective instances and silently corrupt activations; use "
            "the branch-free scheduler (unconditional=True/None)")
    dgroup = mesh.axis_group(data) if data else None
    sgroup = mesh.axis_group(seq) if seq else None
    pgroup = mesh.axis_group(pp_axis) if n_stages > 1 else None
    dp_size = dgroup.size if dgroup is not None else 1

    def over_ranks(loss):
        """A rank's mean of microbatch losses as the reference's global
        one: summed over the sequence shards, averaged over the data
        ranks (no gradient crosses)."""
        if sgroup is not None:
            loss = sum_over(sgroup, loss)
        if dgroup is not None:
            loss = mean_over(dgroup, loss)
        return loss

    def microbatch_loss(head_params, y, labels):
        ys, ls = _microbatches(y, n_micro), _microbatches(labels, n_micro)
        per = torch.stack([head_loss_fn(head_params, ys[m], ls[m]).float()
                           for m in range(n_micro)])
        return per.mean()

    def run(spec, x, labels, leaves):
        """The timetable on this rank: (loss, [gradient of each leaf or
        None], x's gradient or None), normalised as ``finalize``."""
        n_s = spec[1]
        group = pgroup
        stage = group.rank if group is not None else 0
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        stacked = tree_unflatten(params[:n_s], spec[0])
        head = tree_unflatten(params[n_s:], spec[2])
        xs = _microbatches(x.detach(), n_micro)
        ls = _microbatches(labels, n_micro)
        want = [i for i, p in enumerate(params) if p.requires_grad]
        acc = {i: None for i in want}
        dx = torch.zeros_like(xs) if x.requires_grad else None
        loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        graphs, pending = {}, []
        last = stage == n_stages - 1
        for t in range(2 * (n_micro + n_stages - 1)):
            m, ok = _f_sched(stage, t, n_stages, n_micro)
            if ok:
                inp = xs[m] if stage == 0 else _recv(group, xs[m], stage - 1)
                inp = inp.detach().requires_grad_(stage > 0
                                                  or x.requires_grad)
                with torch.enable_grad():
                    y = stage_fn(stacked, inp)
                graphs[m] = (inp, y)
                _hold(1)
                if not last:
                    _send(group, y, stage + 1, pending)
            m, ok = _b_sched(stage, t, n_stages, n_micro)
            if not ok:
                continue
            inp, y = graphs.pop(m)
            needs = [params[i] for i in want
                     if last or i < n_s] + ([inp] if inp.requires_grad
                                            else [])
            with torch.enable_grad():
                if last:
                    out = head_loss_fn(head, y, ls[m]).float()
                    gs = torch.autograd.grad(out, needs, allow_unused=True)
                    loss_acc = loss_acc + out.detach()
                else:
                    seed = _recv(group, y, stage + 1)
                    gs = torch.autograd.grad(y, needs, seed,
                                             allow_unused=True)
            del y
            _hold(-1)
            k = 0
            for i in want:
                if not (last or i < n_s):
                    continue
                g = gs[k] if gs[k] is not None else torch.zeros_like(
                    params[i])
                acc[i] = g if acc[i] is None else acc[i] + g
                k += 1
            if inp.requires_grad:
                if stage > 0:
                    _send_back(group, gs[-1], stage - 1, pending)
                else:
                    dx[m] = gs[-1]
        _wait(pending)
        grads = [None if not p.requires_grad else torch.zeros_like(p)
                 if acc[i] is None else acc[i] for i, p in enumerate(params)]
        return _finalize(loss_acc, grads, dx, n_s, x)

    def _finalize(loss_acc, grads, dx, n_s, x):
        """The reference's ``finalize``: the loss and the head's gradient
        summed over pp, under seq summed over it with the stage's, x's
        gradient stage 0's scaled by 1 / dp, all by 1 / M, then the data
        ranks' mean."""
        loss = loss_acc
        if pgroup is not None:
            loss = sum_over(pgroup, loss)
            grads = [g if g is None or i < n_s else sum_over(pgroup, g)
                     for i, g in enumerate(grads)]
        loss = loss / n_micro
        if sgroup is not None:
            loss = sum_over(sgroup, loss)
            grads = [None if g is None else sum_over(sgroup, g)
                     for g in grads]
        if dx is not None:
            if pgroup is not None:
                dx = sum_over(pgroup, dx)
            dx = dx.reshape(x.shape) / dp_size / n_micro
        grads = [None if g is None else g / n_micro for g in grads]
        if dgroup is not None:
            loss = mean_over(dgroup, loss)
            grads = [None if g is None else mean_over(dgroup, g).to(g.dtype)
                     for g in grads]
        return loss, grads, dx

    def loss_fn(stacked_params, head_params, x, labels):
        if x.shape[0] % n_micro:
            raise ValueError(f"local batch {x.shape[0]} not divisible by "
                             f"{n_micro} microbatches")
        s_leaves, s_spec = tree_flatten(stacked_params)
        h_leaves, h_spec = tree_flatten(head_params)
        leaves = s_leaves + h_leaves
        if not (_trainable(x) or any(_trainable(p) for p in leaves)):
            with torch.no_grad():
                y = pipeline_forward(stage_fn, stacked_params, x, n_micro,
                                     mesh=mesh, pp_axis=pp_axis,
                                     data_axes=data_axes, seq_axis=seq_axis)
                return over_ranks(microbatch_loss(head_params, y, labels))
        if pgroup is None and dgroup is None and sgroup is None:
            y = stage_fn(stacked_params, x)
            return microbatch_loss(head_params, y, labels)
        spec = (s_spec, len(s_leaves), h_spec)
        return _OneFOneB.apply(run, spec, x, labels.detach(), *leaves)

    return loss_fn
