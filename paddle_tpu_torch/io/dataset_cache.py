"""Shared dataset-cache plumbing for vision/text datasets (port of
paddle_tpu/io/dataset_cache.py).

The reference downloads archives into ~/.cache/paddle/dataset
(python/paddle/dataset/common.py DATA_HOME); the port never downloads:
datasets read the same locations and fail with one consistent,
actionable error when a file is absent.
"""
from __future__ import annotations

import os

CACHE_ROOT = os.environ.get(
    "PADDLE_TPU_DATASET_HOME",
    os.path.expanduser("~/.cache/paddle/dataset"))


def cache_path(*parts: str) -> str:
    return os.path.join(CACHE_ROOT, *parts)


def require_file(name: str, path: str) -> str:
    """Return ``path`` if it exists, else raise the zero-egress error."""
    if not os.path.exists(path):
        raise RuntimeError(
            f"{name}: file {path!r} not found and the port does not "
            f"download; place the standard files there or use a "
            f"synthetic dataset (vision.datasets.FakeData / "
            f"text.FakeTextDataset)")
    return path
