"""Fleet's distributed metrics (port of paddle_tpu/distributed/fleet/
metrics.py): sum / max / min / auc / mae / mse / rmse / acc of
worker-local numpy statistics, merged over the world with
``distributed.all_reduce``.  As the reference, a statistic crosses the
ranks in f32 and comes back as f64 (``:19-29``); a world of one rank
reduces nothing."""
from __future__ import annotations

import numpy as np

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc"]


def _merge(arr: np.ndarray, op: str) -> np.ndarray:
    arr = np.asarray(arr, np.float64)
    from paddle_tpu_torch.distributed import collective as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        import torch
        t = torch.from_numpy(arr.astype(np.float32))
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op])
        return np.asarray(t.numpy(), np.float64)
    return arr


def sum(input):                                        # noqa: A001
    """Global elementwise sum of a worker-local stat array."""
    return _merge(input, "sum")


def max(input):                                        # noqa: A001
    return _merge(input, "max")


def min(input):                                        # noqa: A001
    return _merge(input, "min")


def auc(stat_pos, stat_neg):
    """Distributed AUC from per-worker score-bucket histograms (counts of
    positive and negative examples per bucket, ascending score): the
    buckets summed over the workers, then the ROC area by trapezoids."""
    pos = _merge(np.asarray(stat_pos, np.float64).ravel(), "sum")
    neg = _merge(np.asarray(stat_neg, np.float64).ravel(), "sum")
    total_pos = float(pos.sum())
    total_neg = float(neg.sum())
    if total_pos == 0.0 or total_neg == 0.0:
        return 0.5
    area = 0.0
    h = f = 0.0                      # cumulative tp / fp from the top
    for i in range(len(pos) - 1, -1, -1):
        h_new, f_new = h + float(pos[i]), f + float(neg[i])
        area += (f_new - f) * (h + h_new) / 2.0
        h, f = h_new, f_new
    return area / (total_pos * total_neg)


def mae(abserr, total_ins_num):
    """Global mean absolute error: sum(|err|) / sum(n)."""
    e = float(_merge(np.asarray(abserr, np.float64).ravel(), "sum").sum())
    n = float(_merge(np.asarray(total_ins_num, np.float64).ravel(),
                     "sum").sum())
    return e / n if n else 0.0


def mse(sqrerr, total_ins_num):
    e = float(_merge(np.asarray(sqrerr, np.float64).ravel(), "sum").sum())
    n = float(_merge(np.asarray(total_ins_num, np.float64).ravel(),
                     "sum").sum())
    return e / n if n else 0.0


def rmse(sqrerr, total_ins_num):
    return float(np.sqrt(mse(sqrerr, total_ins_num)))


def acc(correct, total):
    c = float(_merge(np.asarray(correct, np.float64).ravel(), "sum").sum())
    t = float(_merge(np.asarray(total, np.float64).ravel(), "sum").sum())
    return c / t if t else 0.0
