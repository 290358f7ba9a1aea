"""Linear algebra (port of paddle_tpu/tensor/linalg.py).

The reference's conventions, where PyTorch's differ:

- ``lu`` returns 0-based int32 pivots (``jax.scipy.linalg.lu_factor``,
  ``:185-190``); ``torch.linalg.lu_factor``'s are 1-based;
- ``slogdet`` stacks [sign, log|det|] into one tensor (``:108-112``);
- ``svd`` returns Vh; ``qr(mode="r")`` returns R alone;
  ``cholesky(upper=True)`` swaps the last two axes;
  ``cholesky_solve(x, y)`` takes the right-hand side first and the
  factor second and solves by two triangular solves (``:90-97``);
  ``triangular_solve(transpose=True)`` solves with the transpose;
- ``pinv(rcond)`` is jnp's relative cutoff (``:162``); ``lstsq``
  returns jnp's four outputs (``:181-183``), all from one SVD on the
  device: the solution, the squared residual norms of each column
  (jnp's, never empty), the rank and the singular values;
- ``matrix_rank`` counts singular values above ``tol`` (absolute), or
  above jnp's default ``max(s) * max(M, N) * eps``, and ignores
  ``hermitian``; ``cond(p=None)`` is the ratio of the extreme singular
  values;
- ``cov`` / ``corrcoef`` follow ``rowvar`` and ignore ``fweights`` /
  ``aweights`` (``:197-199``), as the reference does;
- ``norm(p="fro")`` with no axis is ``sqrt(sum(x * x))``, so an all-zero
  input has a NaN gradient, as in the reference;
- ``histogram`` returns its counts in x's float dtype, its edges
  ``linspace(min, max, bins + 1)`` (from the data when ``min == max ==
  0``), all on the device; ``bincount`` is int64, or float64 with
  weights;
- ``cholesky`` / ``inverse`` / ``solve`` of a singular or indefinite
  matrix give NaN or inf values, as jnp's, where PyTorch's checked
  forms would raise after a read from the device;
- ``mode`` raises ``NotImplementedError``, as the reference's
  (``:216-220``); the tensor namespace's ``mode`` is ``search.mode``.

Host reads: ``eig`` / ``eigvals`` (``torch.linalg.eig`` synchronises on
CUDA; the reference runs numpy on the host) and ``bincount`` (its
length) read back.  Signs and order of singular and eigen vectors, and
the order of ``eig``'s eigenvalues, are not defined.
"""
from __future__ import annotations

import builtins

import torch

from paddle_tpu_torch.tensor._common import inexact, promote, reduce_dims

__all__ = [
    "matmul", "bmm", "mm", "mv", "norm", "dist", "cond", "cholesky",
    "cholesky_solve", "inverse", "det", "slogdet", "svd", "qr", "eig",
    "eigh", "eigvals", "eigvalsh", "matrix_power", "matrix_rank", "multi_dot",
    "pinv", "solve", "triangular_solve", "lstsq", "lu", "corrcoef", "cov",
    "histogram", "bincount", "mode",
]

_INF = float("inf")


def _float(x):
    return x.to(inexact(x.dtype))


def _svd(a, full_matrices=False):
    """torch.linalg.svd with cuSOLVER's QR-iteration driver on the card:
    PyTorch's default there (Jacobi, gesvdj) left 1.6e-4 relative in the
    reconstruction of GPT-2 345M's 8,184 x 1,024 hidden states, gesvd
    3.9e-6 (an H100, chip_smoke.py's tensor-probe); LAPACK, as the
    reference's, on the CPU."""
    kw = {"driver": "gesvd"} if a.is_cuda else {}
    return torch.linalg.svd(a, full_matrices=full_matrices, **kw)


def _svdvals(a):
    kw = {"driver": "gesvd"} if a.is_cuda else {}
    return torch.linalg.svdvals(a, **kw)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    _, _, (a, b) = promote(x, y)
    if transpose_x and a.ndim > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.ndim > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


def _vector_norm(a, p, dims, keepdim):
    """jnp.linalg.vector_norm over ``dims``."""
    if p == 2:
        return torch.sqrt(torch.sum(a * a, dim=dims, keepdim=keepdim))
    if p == _INF:
        return torch.amax(a.abs(), dim=dims, keepdim=keepdim)
    if p == -_INF:
        return torch.amin(a.abs(), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
    if p == 1:
        return torch.sum(a.abs(), dim=dims, keepdim=keepdim)
    s = torch.sum(a.abs() ** float(p), dim=dims, keepdim=keepdim)
    return s ** (1.0 / p)


def _matrix_norm(a, p, dims, keepdim):
    """jnp.linalg.norm over two axes."""
    row, col = dims
    if p == "fro":
        return torch.sqrt(torch.sum(a * a, dim=dims, keepdim=keepdim))
    if p in (1, -1, _INF, -_INF):
        red, over = (row, col) if p in (1, -1) else (col, row)
        if not keepdim and over > red:
            over -= 1
        s = torch.sum(a.abs(), dim=red, keepdim=keepdim)
        return (torch.amax if p in (1, _INF) else torch.amin)(
            s, dim=over, keepdim=keepdim)
    if p in ("nuc", 2, -2):
        sv = _svdvals(a.movedim(dims, (-2, -1)))
        out = {2: lambda: sv.amax(-1), -2: lambda: sv.amin(-1),
               "nuc": lambda: sv.sum(-1)}[p]()
        if keepdim:
            for d in sorted(dims):
                out = out.unsqueeze(d)
        return out
    raise ValueError(f"Invalid order '{p}' for matrix norm.")


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The reference's norm: no axis and ``p="fro"``: ``sqrt(sum(x *
    x))``; no axis and another p: the vector norm of x flattened (shape
    (1,) with ``keepdim``); a list axis: the matrix norm over its two
    axes (``"fro"``, ``"nuc"``, 1, -1, 2, -2, inf, -inf) or the vector
    norm over one; an int axis: ``"fro"`` is the 2-norm, inf / -inf the
    largest / smallest ``|x|``, 0 the count of nonzeros, else
    ``sum(|x| ** p) ** (1 / p)``."""
    from paddle_tpu_torch.tensor.math import pow
    a = _float(x)
    if axis is None and p == "fro":
        return torch.sqrt(torch.sum(a * a))
    if axis is None:
        return _vector_norm(a.reshape(-1), 2 if p is None else p, (0,),
                            keepdim)
    if isinstance(axis, (list, tuple)):
        dims = reduce_dims(axis, a.ndim)
        if len(dims) == 1:
            return _vector_norm(a, 2 if p in (None, "fro") else p, dims,
                                keepdim)
        return _matrix_norm(a, "fro" if p is None else p, dims, keepdim)
    axis = int(axis)
    if p == "fro":
        return torch.sqrt(torch.sum(a * a, dim=axis, keepdim=keepdim))
    if p == _INF:
        return torch.amax(a.abs(), dim=axis, keepdim=keepdim)
    if p == -_INF:
        return torch.amin(a.abs(), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim=axis, keepdim=keepdim)
    s = torch.sum(pow(a.abs(), p), dim=axis, keepdim=keepdim)
    return pow(s, 1.0 / p)


def dist(x, y, p=2, name=None):
    """The p-norm of x - y (``:66-77``)."""
    from paddle_tpu_torch.tensor.math import pow, subtract
    d = _float(subtract(x, y))
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    if p == _INF:
        return d.abs().amax()
    if p == -_INF:
        return d.abs().amin()
    return pow(torch.sum(pow(d.abs(), p)), 1.0 / p)


def cond(x, p=None, name=None):
    """The condition number: for p None or 2 the ratio of the extreme
    singular values, else ``norm(x, p) * norm(inv(x), p)`` (inf where
    that is NaN for a NaN-free x)."""
    a = _float(x)
    if p is None or p == 2:
        s = _svdvals(a)
        return s[..., 0] / s[..., -1]
    if p == -2:
        s = _svdvals(a)
        r = s[..., -1] / s[..., 0]
    else:
        dims = (a.ndim - 2, a.ndim - 1)
        r = _matrix_norm(a, p, dims, False) * _matrix_norm(
            inverse(a), p, dims, False)
    nan_free = ~torch.isnan(a).any(-1).any(-1)
    return torch.where(torch.isnan(r) & nan_free,
                       torch.full_like(r, _INF), r)


def cholesky(x, upper=False, name=None):
    """The lower factor L (its transpose for ``upper``); NaN where x is
    not positive definite."""
    a = _float(x)
    low, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0).reshape(*info.shape, 1, 1)
    low = torch.where(bad, torch.full_like(low, float("nan")), low)
    return low.transpose(-1, -2) if upper else low


def cholesky_solve(x, y, upper=False, name=None):
    """The solution of A X = x, where y is A's Cholesky factor (lower,
    or upper for ``upper``)."""
    _, _, (b, low) = promote(x, y, inexact_result=True)
    if upper:
        low = low.transpose(-1, -2)
    z = torch.linalg.solve_triangular(low, b, upper=False)
    return torch.linalg.solve_triangular(low.transpose(-1, -2), z,
                                         upper=True)


def inverse(x, name=None):
    return torch.linalg.inv_ex(_float(x))[0]


def det(x, name=None):
    return torch.linalg.det(_float(x))


def slogdet(x, name=None):
    """[sign, log|det|] stacked into one tensor."""
    sign, logabs = torch.linalg.slogdet(_float(x))
    return torch.stack([sign, logabs])


def svd(x, full_matrices=False, name=None):
    """(U, S, Vh)."""
    return tuple(_svd(_float(x), full_matrices))


def qr(x, mode="reduced", name=None):
    """(Q, R), or R alone for ``mode="r"``."""
    q, r = torch.linalg.qr(_float(x), mode=mode)
    return r if mode == "r" else (q, r)


def eig(x, name=None):
    """(eigenvalues, eigenvectors), complex.  Synchronises with the host
    on CUDA."""
    return tuple(torch.linalg.eig(_float(x)))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(_float(x), UPLO=UPLO))


def eigvals(x, name=None):
    """Complex eigenvalues.  Synchronises with the host on CUDA."""
    return torch.linalg.eigvals(_float(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(_float(x), UPLO=UPLO)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The number of singular values above ``tol`` (absolute), or above
    ``max(s) * max(M, N) * eps``; int64 (int32 for a vector: whether any
    entry is nonzero)."""
    a = _float(x)
    if a.ndim < 2:
        return (a != 0).any().to(torch.int32)
    s = _svdvals(a)
    if tol is None:
        tol = s.amax(-1) * builtins.max(a.shape[-2:]) * \
            torch.finfo(s.dtype).eps
    elif not isinstance(tol, torch.Tensor):
        tol = torch.full((), tol, dtype=s.dtype, device=s.device)
    return torch.sum(s > tol.unsqueeze(-1), dim=-1)


def multi_dot(x, name=None):
    _, _, mats = promote(*x)
    return torch.linalg.multi_dot(mats)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """The pseudo-inverse: singular values up to ``rcond`` times the
    largest count as zero (``hermitian`` is ignored, as the reference
    ignores it)."""
    return torch.linalg.pinv(_float(x), rtol=rcond)


def solve(x, y, name=None):
    """The solution of x X = y: y a vector when 1-D, else a (batch of)
    matrix."""
    _, _, (a, b) = promote(x, y, inexact_result=True)
    if b.ndim == 1:
        return torch.linalg.solve_ex(a, b.unsqueeze(-1))[0].squeeze(-1)
    return torch.linalg.solve_ex(a, b)[0]


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """The solution of x X = y (x^T X = y for ``transpose``) with x
    triangular."""
    _, _, (a, b) = promote(x, y, inexact_result=True)
    vec = b.ndim == 1
    if vec:
        b = b.unsqueeze(-1)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    out = torch.linalg.solve_triangular(a, b, upper=upper,
                                        unitriangular=unitriangular)
    return out.squeeze(-1) if vec else out


def lstsq(x, y, rcond=None, driver=None, name=None):
    """jnp.linalg.lstsq of a 2-D x: (solution, squared residual norm of
    each column of y - x @ solution, rank, singular values), from one
    SVD; singular values below ``rcond`` (default ``eps * max(M, N)``)
    times the largest are dropped."""
    _, _, (a, b) = promote(x, y, inexact_result=True)
    vec = b.ndim == 1
    if vec:
        b = b.unsqueeze(-1)
    m, n = a.shape
    eps = torch.finfo(a.dtype).eps
    rc = eps * builtins.max(m, n) if rcond is None else (
        eps if rcond < 0 else rcond)
    u, s, vh = _svd(a)
    mask = (s > 0) & (s >= rc * s[0])
    rank = mask.sum()
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s)).unsqueeze(-1)
    sol = vh.transpose(-1, -2) @ (s_inv * (u.transpose(-1, -2) @ b))
    r = b - a @ sol
    resid = torch.sqrt(torch.sum(r * r, dim=0)) ** 2
    return (sol.reshape(-1) if vec else sol), resid, rank, s


def lu(x, pivot=True, get_infos=False, name=None):
    """(packed LU, 0-based int32 pivots[, int32 info 0])."""
    lu_, piv = torch.linalg.lu_factor(_float(x))
    outs = (lu_, (piv - 1).to(torch.int32))
    if get_infos:
        outs += (torch.zeros((), dtype=torch.int32, device=lu_.device),)
    return outs


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None,
        name=None):
    """jnp.cov: variables in rows (columns if not ``rowvar``), ddof 1
    (0 if not ``ddof``); ``fweights`` / ``aweights`` are ignored, as the
    reference ignores them."""
    a = _float(x)
    m = a.reshape(1, -1) if a.ndim == 1 else a
    if not rowvar and a.ndim != 1:
        m = m.transpose(0, 1)
    m = m - m.mean(1, keepdim=True)
    c = (m @ m.transpose(0, 1)) / (m.shape[1] - (1 if ddof else 0))
    return c.squeeze()


def corrcoef(x, rowvar=True, name=None):
    """cov scaled by the standard deviations, clipped to [-1, 1] by
    ``maximum`` / ``minimum``."""
    c = cov(x, rowvar)
    if c.ndim == 0:
        return c / c
    sd = torch.sqrt(torch.diagonal(c))
    c = c / sd[:, None] / sd[None, :]
    one = torch.ones((), dtype=c.dtype, device=c.device)
    return torch.minimum(one, torch.maximum(-one, c))


def _edges(a, bins, lo, hi):
    """histogram_bin_edges: ``linspace(lo, hi, bins + 1)`` in a's float
    dtype, widened by 0.5 each way when lo == hi."""
    from paddle_tpu_torch.tensor.creation import _linspace
    lo, hi = (v.to(a.dtype) if isinstance(v, torch.Tensor) else
              torch.full((), v, dtype=torch.float64, device=a.device)
              .to(a.dtype) for v in (lo, hi))
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    return _linspace(lo, hi, bins + 1, a.dtype, a.device)


def _bin_index(a, edges):
    idx = torch.searchsorted(edges, a, right=True)
    return torch.where(a == edges[-1], idx - 1, idx)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of ``input`` in ``bins`` equal bins over [min, max] (the
    data's range when both are 0), the last bin closed; values outside
    are dropped.  Float counts (x's float dtype); no gradient."""
    a = _float(input.detach()).reshape(-1)
    if min != 0 or max != 0:
        lo, hi = min, max
    else:
        lo, hi = a.min(), a.max()
    edges = _edges(a, int(bins), lo, hi)
    idx = _bin_index(a, edges)
    counts = torch.zeros(edges.shape[0] + 1, dtype=a.dtype, device=a.device)
    counts.index_add_(0, idx, torch.ones_like(a))
    return counts[1:edges.shape[0]]


def bincount(x, weights=None, minlength=0, name=None):
    """Counts of each non-negative integer of x (int64), or the sums of
    its ``weights`` (float64).  Reads its length back from the device."""
    if weights is None:
        return torch.bincount(x, minlength=minlength)
    return torch.bincount(x, weights=weights.to(torch.float64),
                          minlength=minlength)


def mode(x, axis=-1, keepdim=False, name=None):
    raise NotImplementedError("mode: use paddle_tpu_torch.tensor.search.mode")
