"""The port's ingest plane (paddle_tpu_torch/io/pipeline.py) against the
reference's on the CPU.

The pipelined stream (prefetch depth 1 and 3) is the sequential loader's
byte for byte — order, values, dtypes — and the reference pipeline's
values; an injected ``data.pipeline`` fault degrades that one batch to a
synchronous fetch in both packages, the stream unchanged.  The decoded-
sample caches (memory, disk) record on epoch 1 and hit on epoch 2 with
the reference's counts; a stale disk directory raises.  Both packages
export the same statistics, histograms and span names.  On the CPU
``to_device`` shares the batch's memory; on the card it is a pinned,
``non_blocking`` copy on a side stream (``chip_smoke.py`` phase 59 holds
those batches bitwise).
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu.io import pipeline as jpipe
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.io import pipeline as tpipe

from torch_planes_common import PORT, REF, clean_planes


class Images:
    """uint8 (8, 8, 3) images with an int64 label, from sample i's seed."""

    def __init__(self, n=20):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                np.int64(i % 3))


def _loader(io, ds=None, seed=4):
    ds = ds or Images()
    sampler = io.BatchSampler(sampler=io.RandomSampler(ds, generator=seed),
                              batch_size=6, drop_last=False)
    return io.DataLoader(ds, batch_sampler=sampler,
                         collate_fn=io.numpy_collate)


def _host(batch):
    return [np.asarray(getattr(t, "_data", t)) for t in batch]


def _stream(pipe):
    return [_host(b) for b in pipe]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_pipelined_stream_is_the_sequential_stream(depth):
    """IngestPipeline at prefetch depth 0, 1 and 3: CPU tensors whose
    bytes are the plain loader's batches, and the reference pipeline's
    values."""
    want = [[np.asarray(f) for f in b] for b in _loader(tio)]
    pipe = tpipe.IngestPipeline(_loader(tio), prefetch_depth=depth,
                                device="cpu")
    got = []
    for b in pipe:
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in b)
        got.append([t.numpy() for t in b])
    _equal(got, want)
    _equal(_stream(jpipe.IngestPipeline(_loader(jio),
                                        prefetch_depth=depth)), want)
    assert pipe.batches == 4 and 0.0 <= pipe.input_stall_pct <= 100.0


def test_chaos_fault_degrades_one_batch():
    """A data.pipeline fault on the 2nd background task: the stream is
    unchanged and one prefetch miss is counted, as the reference's."""
    want = [[np.asarray(f) for f in b] for b in _loader(tio)]
    counts = {}
    with clean_planes():
        for name, pkg, io, pipe_mod, kw in (
                ("ref", REF, jio, jpipe, {}),
                ("port", PORT, tio, tpipe, {"device": "cpu"})):
            with pkg.chaos.inject("data.pipeline", mode="error", nth=2):
                got = _stream(pipe_mod.IngestPipeline(
                    _loader(io), prefetch_depth=1, **kw))
            _equal(got, want)
            counts[name] = (
                pkg.monitor.get_stat("ingest_prefetch_misses_total"),
                pkg.monitor.get_stat("ingest_prefetch_hits_total"),
                pkg.monitor.get_stat("ingest_batches_total"))
            pkg.monitor.StatRegistry.instance()._stats.clear()
    assert counts["port"] == counts["ref"] == (1, 3, 4)


@pytest.mark.parametrize("mode", ["memory", "disk"])
def test_sample_cache_records_then_hits(mode, tmp_path):
    """CachedDataset over a SampleCache: epoch 1 misses every sample and
    records it, epoch 2 hits every one with the same stream, the
    reference's counts; a disk directory is stamped and a different
    dataset binding it raises."""
    counts = {}
    with clean_planes():
        for name, pkg, io, pipe_mod in (("ref", REF, jio, jpipe),
                                        ("port", PORT, tio, tpipe)):
            cache = pipe_mod.SampleCache(
                mode=mode, cache_dir=str(tmp_path / name), max_bytes=1 << 20)
            cds = pipe_mod.CachedDataset(Images(), cache)
            e1 = [[np.asarray(f) for f in b] for b in _loader(io, cds)]
            e2 = [[np.asarray(f) for f in b] for b in _loader(io, cds)]
            _equal(e1, e2)
            _equal(e1, [[np.asarray(f) for f in b] for b in _loader(tio)])
            counts[name] = (cache.misses, cache.hits,
                            pkg.monitor.get_stat("ingest_cache_hits_total"),
                            pkg.monitor.get_stat(
                                "ingest_cache_misses_total"))
            if mode == "disk":
                files = sorted(os.listdir(tmp_path / name))
                assert "meta.json" in files and len(files) == 21
                assert not any(".tmp" in f for f in files)
                with pytest.raises(ValueError, match="stale"):
                    pipe_mod.CachedDataset(Images(7), cache)
    assert counts["port"] == counts["ref"] == (20, 20, 20, 20)
    if mode == "disk":
        assert json.load(open(tmp_path / "port" / "meta.json")) == \
            json.load(open(tmp_path / "ref" / "meta.json"))


def test_cache_bound_stops_inserts():
    """A memory cache bounded at five samples (192 image bytes and 16
    nominal label bytes each): inserts stop at the
    bound, later lookups past it miss, nothing breaks."""
    cache = tpipe.SampleCache(mode="memory", max_bytes=5 * 208)
    cds = tpipe.CachedDataset(Images(), cache)
    for _ in range(2):
        list(_loader(tio, cds))
    assert cache.bytes_used == 5 * 208 and cache.hits == 5


def test_exports_the_reference_names(tmp_path):
    """One pipelined epoch in each package: the same ingest statistics,
    histograms and span names."""
    names = {}
    with clean_planes():
        for name, pkg, io, pipe_mod, kw in (
                ("ref", REF, jio, jpipe, {}),
                ("port", PORT, tio, tpipe, {"device": "cpu"})):
            pkg.obs.tracer.enable(str(tmp_path / name), label=name)
            try:
                for _ in pipe_mod.IngestPipeline(_loader(io), **kw):
                    pass
            finally:
                pkg.obs.tracer.disable()
            spans = sorted({r["name"] for r in REF.obs.span_summary(
                str(tmp_path / name))})
            names[name] = (sorted(k for k in pkg.monitor.all_stats()
                                  if "ingest" in k or "stall" in k),
                           sorted(k for k in pkg.monitor.all_histograms()
                                  if k.startswith("ingest")), spans)
            pkg.monitor.StatRegistry.instance()._stats.clear()
            pkg.monitor._hists.clear()
    assert names["port"] == names["ref"]
    stats, hists, spans = names["port"]
    assert "input_stall_pct" in stats
    assert set(hists) >= {"ingest_decode_ms", "ingest_collate_ms",
                          "ingest_transfer_ms", "ingest_wait_ms"}
    assert set(spans) >= {"ingest.fetch", "ingest.decode",
                          "ingest.transfer", "ingest.wait"}


def test_early_exit_and_reentry():
    """Breaking out flushes the background work; re-entering yields the
    loader's next epoch whole (the sampler's stream moved on, as the
    plain loader's does)."""
    plain = _loader(tio)
    list(plain)
    want = [[np.asarray(f) for f in b] for b in plain]
    pipe = tpipe.IngestPipeline(_loader(tio), prefetch_depth=2,
                                device="cpu")
    for _ in pipe:
        break
    pipe.flush()
    _equal([[t.numpy() for t in b] for b in pipe], want)


def test_to_device_on_the_cpu_shares_memory():
    """to_device on the CPU: nested structure kept, tensors over the
    arrays' memory, tensors and other leaves passed through."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = torch.ones(2)
    out = tpipe.to_device({"a": [a, t], "s": "x"}, device="cpu")
    assert out["s"] == "x" and out["a"][1] is t
    assert out["a"][0].data_ptr() == a.ctypes.data
