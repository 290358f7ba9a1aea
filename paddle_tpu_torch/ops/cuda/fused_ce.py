"""Fused linear + softmax cross-entropy, forward and backward (port of
paddle_tpu/ops/pallas/fused_ce.py).

Per-token ``-log softmax(h @ W.T)[label]`` and its gradients without the
(N, V) logits in device memory.  The kernels are hand-written CUDA for
sm_90a: ``csrc/fused_ce_fwd.cu`` replaces the Pallas ``_fwd_kernel`` (the
logz pass; in bf16 a wgmma GEMM whose epilogue writes a (max, sum) pair per
token and vocabulary tile into a scratch buffer this module allocates,
merged by a second kernel), ``csrc/fused_ce_bwd.cu`` the ``_dh_kernel``
and ``_dw_kernel`` (in bf16, three wgmma GEMMs over chunks of the
vocabulary on the same mainloop, whose (N, V_c) probabilities live in a
scratch buffer this module allocates).
Two ``torch.library`` custom ops tie them together as the reference's
``custom_vjp`` does (``_fused_ce`` :259-309): ``paddle_tpu_torch::
fused_ce_fwd`` gives the per-token loss and saves h, W, the labels and
logz; ``paddle_tpu_torch::fused_ce_bwd``, its registered backward, makes
one call that computes dh and dW, then adds the gold-label terms in
PyTorch, O(N*H) as the reference's XLA gather and
scatter are: ``-g * W[label]`` into dh in dh's dtype, and ``-g * h``
scattered into dW through an f32 ``index_add_`` (repeated labels would
round to nothing in a bf16 sum).

The ops stay nodes of a graph that ``torch.export`` captures
(``jit.to_static``, ``jit.save``), their launches counted there too.
Dispatch is by the device of the tensors it is given (each op's kernel
registered for "cpu" and for "cuda"): a CPU tensor takes the plain
PyTorch versions, :func:`ce_logz_reference` and
:func:`ce_bwd_reference`; a CUDA tensor launches the kernels or raises.
:func:`supported` sends f16 heads to the unfused head by rule.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

__all__ = ["supported", "ce_logz", "ce_logz_reference", "ce_bwd_reference",
           "chunk_width", "fused_linear_cross_entropy", "xla_reference",
           "launches", "launches_dh", "launches_dw"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (tokens per block, vocab rows per tile) of the forward kernel, by dtype
_BLOCKS = {torch.float32: (64, 64), torch.bfloat16: (128, 256)}
_TARGET_BLOCKS = 4 * 132   # f32: a few resident 256-thread blocks an SM
# The bf16 backward's scratch: the (N, V_c) bf16 probabilities of one
# vocabulary chunk take at most this many bytes (V_c a multiple of _V_TILE)
P_BUDGET = 128 << 20
_V_TILE = 128

# kernel launches made by this process (read by chip_smoke.py): the logz
# forward, and for each backward call one dh and one dW (in bf16 the
# call's P and dh passes, and its dW passes, over every chunk)
launches = 0
launches_dh = 0
launches_dw = 0
_count_lock = threading.Lock()   # ranks simulated as threads launch too

_fns: dict = {}


def supported(n: int, h: int, dtype=None) -> bool:
    """The reference's rule (``supported`` :52), any token count and a
    hidden width that is a multiple of 128, narrowed to what the kernels
    take: ``dtype`` (the head's, when given) float32 or bfloat16, for the
    forward and the backward alike.  The reference's kernels are
    dtype-generic; here an f16 head goes to the unfused head, on every
    device."""
    if n < 0 or h % 128:
        return False
    return dtype is None or dtype in _DTYPES


def ce_logz_reference(h, w):
    """Plain PyTorch version: logz (N,) f32 = logsumexp over the V rows of
    W of the f32 logits ``h @ W.T`` (the products of the input dtype,
    accumulated in f32)."""
    return torch.logsumexp(h.float() @ w.float().T, dim=-1)


def ce_bwd_reference(h, w, logz, g):
    """Plain PyTorch version of the backward kernels (reference
    ``_ce_bwd_kernels`` :186), without the gold-label terms: with
    ``p = exp(h @ W.T - logz) * g`` rounded to W's dtype, returns
    ``(p @ W, p.T @ h)`` accumulated in f32 and written in h's and W's
    dtypes."""
    s = h.float() @ w.float().T
    p = (torch.exp(s - logz[:, None]) * g.float()[:, None]).to(w.dtype)
    dh = (p.float() @ w.float()).to(h.dtype)
    dw = (p.float().T @ h.float()).to(w.dtype)
    return dh, dw


def chunk_width(n: int, v: int, budget: int = P_BUDGET) -> int:
    """V_c of the bf16 backward for N tokens and V vocabulary rows: the
    vocabulary runs in ``ceil(V / V_c)`` chunks of V_c rows, the last one
    shorter where V_c does not divide V.  V_c is a multiple of 128, the
    (N, V_c) bf16 probabilities fit in ``budget`` bytes (or V_c is 128),
    and the chunks are as even as that allows."""
    cap = max(_V_TILE, budget // (2 * max(n, 1)) // _V_TILE * _V_TILE)
    rows = -(-v // -(-v // cap))          # V over the fewest chunks
    return -(-rows // _V_TILE) * _V_TILE


def _n_split(n: int, v: int, dtype) -> int:
    """Vocab splits of the forward grid, each a run of ceil(tiles / splits)
    vocab tiles that writes one (max, sum) pair per token.  bf16: one split
    per 256-row tile, a block for each (token tile, vocab tile); f32:
    enough splits to fill the card."""
    block_n, block_v = _BLOCKS[dtype]
    n_vt = -(-v // block_v)
    if dtype == torch.bfloat16:
        return n_vt
    n_tiles = -(-n // block_n)
    return max(1, min(n_vt, -(-_TARGET_BLOCKS // n_tiles)))


def _kernel(name: str):
    """The ctypes function of kernel ``name`` ('fwd', 'bwd_bf16',
    'bwd_f32'), typed."""
    fn = _fns.get(name)
    if fn is None:
        from paddle_tpu_torch.ops.cuda import _build
        # (library, symbol, pointers, ints); the stream comes last
        lib, sym, ptrs, ints = {
            "fwd": ("fused_ce_fwd", "pt_ce_logz_fwd", 4, 5),
            "bwd_bf16": ("fused_ce_bwd", "pt_ce_bwd_bf16", 8, 4),
            "bwd_f32": ("fused_ce_bwd", "pt_ce_bwd_f32", 6, 3)}[name]
        fn = getattr(_build.load(lib), sym)
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(h, w):
    """Raise on what the kernels do not take; returns (n, hd, v)."""
    for name, t in (("h", h), ("w", w)):
        if t.device.type != "cuda" or t.device != h.device:
            raise ValueError(f"fused_ce: {name} must lie on the same CUDA "
                             f"device as h, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != h.dtype:
            raise ValueError(f"fused_ce: the kernel takes float32 or "
                             f"bfloat16 h and w of one dtype, got {name} "
                             f"{t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"fused_ce: {name} must be a contiguous 2-D "
                             "tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_ce: {name} must be 16-byte aligned")
    n, hd = h.shape
    v = w.shape[0]
    if w.shape[1] != hd:
        raise ValueError(f"fused_ce: w {tuple(w.shape)} does not match h "
                         f"{tuple(h.shape)}")
    if v == 0:
        raise ValueError("fused_ce: empty vocabulary")
    if h.dtype == torch.bfloat16 and hd % 64:
        raise ValueError(f"fused_ce: the bf16 kernel takes a hidden width "
                         f"that is a multiple of 64, got {hd}")
    return n, hd, v


def _call(name, tensors, ints):
    """Launch kernel ``name`` on the current stream of the tensors' card
    (a tensor given as None passes a null pointer); raise if a launch is
    refused."""
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*(None if t is None else t.data_ptr()
                              for t in tensors), *ints, stream)
    if err != 0:
        raise RuntimeError(f"fused_ce: {name} kernel launch failed with "
                           f"cudaError {err}")


def _launch(h, w):
    """Forward kernel: logz (N,) f32 of h (N, H), w (V, H) on the card."""
    global launches
    n, hd, v = _check(h, w)
    n_split = _n_split(n, v, h.dtype)
    logz = torch.empty(n, dtype=torch.float32, device=h.device)
    # each token's (max, sum) pair of each split
    part = torch.empty(n, n_split, 2, dtype=torch.float32, device=h.device)
    _call("fwd", (h, w, logz, part), (n, hd, v, n_split, _DTYPES[h.dtype]))
    with _count_lock:
        launches += 1
    return logz


def _check_bwd(h, w, logz, g):
    n, hd, v = _check(h, w)
    for name, t in (("logz", logz), ("g", g)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or \
                not t.is_contiguous() or t.device != h.device:
            raise ValueError(f"fused_ce: {name} must be a contiguous ({n},) "
                             "float32 tensor on h's device")
    return n, hd, v


def _launch_bwd(h, w, logz, g, budget=P_BUDGET):
    """The backward kernels on the card (reference ``_dh_kernel`` :138 and
    ``_dw_kernel`` :161): (dh, dW) without the gold terms, in one call.
    In bf16 the vocabulary runs in chunks of :func:`chunk_width` rows
    (``budget`` bounds the probabilities' scratch), three kernels a chunk;
    more than one chunk also takes an (N, H) f32 accumulator."""
    global launches_dh, launches_dw
    n, hd, v = _check_bwd(h, w, logz, g)
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    if h.dtype == torch.bfloat16:
        vc = chunk_width(n, v, budget)
        p = torch.empty(n, vc, dtype=h.dtype, device=h.device)
        acc = torch.empty(n, hd, dtype=torch.float32,
                          device=h.device) if v > vc else None
        _call("bwd_bf16", (h, w, logz, g, dh, dw, p, acc), (n, hd, v, vc))
    else:
        _call("bwd_f32", (h, w, logz, g, dh, dw), (n, hd, v))
    with _count_lock:
        launches_dh += 1
        launches_dw += 1
    return dh, dw


def ce_logz(h, w):
    """logz (N,) f32 of ``h @ w.T`` over the V rows of w, by device."""
    if h.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=h.device)
    if h.device.type == "cpu":
        return ce_logz_reference(h, w)
    if h.device.type == "cuda":
        return _launch(h, w)
    raise ValueError(f"fused_ce: unsupported device {h.device}")


# The two custom ops that carry #5-#7 through eager calls, captured graphs
# and loaded artifacts: the per-token loss with its logz, and the backward
# (the kernels' dh and dW, then the gold-label terms).  Each takes the
# plain version on a CPU tensor and the kernels on a CUDA tensor.
@torch.library.custom_op("paddle_tpu_torch::fused_ce_fwd", mutates_args=())
def fused_ce_fwd_op(h: torch.Tensor, w: torch.Tensor, lab: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss (N,) f32, logz (N,) f32) of h (N, H), w (V, H) and in-range
    int64 labels (reference ``_fused_ce_fwd`` :265)."""
    raise ValueError(f"fused_ce: unsupported device {h.device}")


def _fwd_impl(h, w, lab):
    logz = ce_logz(h, w)
    gold = (h.float() * w[lab].float()).sum(-1)
    return logz - gold, logz.clone()


fused_ce_fwd_op.register_kernel("cpu")(_fwd_impl)
fused_ce_fwd_op.register_kernel("cuda")(_fwd_impl)


@fused_ce_fwd_op.register_fake
def _(h, w, lab):
    n = h.shape[0]
    return (h.new_empty(n, dtype=torch.float32),
            h.new_empty(n, dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::fused_ce_bwd", mutates_args=())
def fused_ce_bwd_op(h: torch.Tensor, w: torch.Tensor, lab: torch.Tensor,
                    logz: torch.Tensor, g: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh, dW) of the per-token loss for its f32 cotangent g (reference
    ``_fused_ce_bwd`` :281)."""
    raise ValueError(f"fused_ce: unsupported device {h.device}")


def _bwd_by(bwd):
    def impl(h, w, lab, logz, g):
        if h.shape[0] == 0:
            return torch.zeros_like(h), torch.zeros_like(w)
        dh, dw = bwd(h, w, logz, g)
        # the gold-label terms (reference :296-305)
        gf = g[:, None]
        dh = dh - (gf * w[lab].float()).to(dh.dtype)
        gold = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        gold.index_add_(0, lab, gf * h.float())
        return dh, (dw.float() - gold).to(dw.dtype)
    return impl


fused_ce_bwd_op.register_kernel("cpu")(_bwd_by(ce_bwd_reference))
fused_ce_bwd_op.register_kernel("cuda")(_bwd_by(_launch_bwd))


@fused_ce_bwd_op.register_fake
def _(h, w, lab, logz, g):
    return torch.empty_like(h), torch.empty_like(w)


def _ce_setup(ctx, inputs, output):
    h, w, lab = inputs
    ctx.save_for_backward(h, w, lab, output[1])
    ctx.mark_non_differentiable(output[1])


def _ce_backward(ctx, g, _dlogz):
    h, w, lab, logz = ctx.saved_tensors
    dh, dw = fused_ce_bwd_op(h, w, lab, logz, g.float().contiguous())
    return dh, dw, None


fused_ce_fwd_op.register_autograd(_ce_backward, setup_context=_ce_setup)


def fused_linear_cross_entropy(h, w, labels):
    """Per-token ``-log softmax(h @ w.T)[label]`` (reference ``:312``),
    differentiable in h and w.

    h (N, H), w (V, H), labels (N,) integer ids.  Negative ids are
    padding: their entry is computed against class 0 and is the caller's
    to mask (multiply the per-token loss by the mask before summing, so
    that its gradient is zero).  Returns (N,) float32.
    """
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ce: unsupported device {h.device}")
    lab = labels.long().clamp(0, w.shape[0] - 1)
    return fused_ce_fwd_op(h, w, lab)[0]


def xla_reference(h, w, labels):
    """Unfused version that materialises the logits (reference ``:333``)."""
    lg = (h @ w.T).float()
    logz = torch.logsumexp(lg, dim=-1)
    lab = labels.long().clamp(0, w.shape[0] - 1)
    return logz - lg.gather(-1, lab[:, None])[:, 0]
