"""``SelectedRows``, the row-sparse gradient (port of
paddle_tpu/framework/selected_rows.py), and how the port carries it.

``embedding(sparse=True)`` (``nn/functional/common.py``) gives its table a
row-sparse gradient on the eager tape: the table's ``.grad`` is an
uncoalesced ``torch.sparse_coo_tensor`` whose indices are the looked-up
ids, one row per id (a ``padding_idx`` row included, with zero values),
so no dense (vocabulary, dim) gradient is made by the backward.  A second
backward adds its rows to the first's (the reference concatenates them;
PyTorch's sparse sum may combine rows of one id, and the merge is the
same).  The eager optimizers read it as a
``SelectedRows`` (:meth:`SelectedRows.from_grad`), merge it
(``MergeAdd``: sorted unique rows, the values of a repeated row summed)
and update row by row where the reference does (``optimizer.py``).

Inside :func:`dense_gradients` the lookup takes the dense path: the
functional step (``jit.functional_loss_call``) differentiates every
parameter densely, as the reference's traced step does (its sparse path
returns None for a tracer).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["SelectedRows", "dense", "dense_gradients", "sparse_allowed"]

_local = threading.local()


@contextlib.contextmanager
def dense_gradients():
    """While the block runs, ``embedding(sparse=True)`` gives dense
    gradients."""
    prev = getattr(_local, "dense", False)
    _local.dense = True
    try:
        yield
    finally:
        _local.dense = prev


def sparse_allowed() -> bool:
    return not getattr(_local, "dense", False)


class SelectedRows:
    """``rows`` (n,) int64 ids into a ``height``-row table and ``values``
    (n, ...), one row of values an id."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        self.values = values
        self.rows = torch.as_tensor(rows, dtype=torch.int64,
                                    device=values.device).reshape(-1)
        self.height = int(height)

    @classmethod
    def from_grad(cls, grad) -> "SelectedRows":
        """The rows of a sparse COO gradient (of a (height, ...) table),
        duplicates and all."""
        return cls(grad._indices()[0], grad._values(), grad.shape[0])

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError("SelectedRows height mismatch")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.height)
        return other.index_add(0, self.rows, self.values.to(other.dtype))

    __radd__ = __add__

    def __mul__(self, scalar):
        return SelectedRows(self.rows, self.values * scalar, self.height)

    __rmul__ = __mul__

    def merge(self) -> "SelectedRows":
        """``MergeAdd``: the sorted unique rows, each with the sum of its
        values."""
        rows, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        acc = self.values.new_zeros((rows.shape[0],)
                                    + tuple(self.values.shape[1:]))
        return SelectedRows(rows, acc.index_add_(0, inv, self.values),
                            self.height)

    def to_dense(self):
        out = self.values.new_zeros((self.height,)
                                    + tuple(self.values.shape[1:]))
        return out.index_add_(0, self.rows, self.values)

    def numpy(self):
        return self.to_dense().detach().cpu().numpy()

    @property
    def shape(self):
        return [self.height] + list(self.values.shape[1:])

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, "
                f"value_shape={tuple(self.values.shape)})")


def dense(grad):
    """A gradient as a dense tensor: a sparse one merged and densified."""
    if grad is not None and grad.is_sparse:
        return SelectedRows.from_grad(grad).merge().to_dense()
    return grad

