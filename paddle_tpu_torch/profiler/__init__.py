"""paddle_tpu_torch.profiler — host and device profiling (port of
paddle_tpu/profiler/__init__.py).

Host spans are :class:`RecordEvent` context managers that both feed an
in-process aggregate table (calls / total / min / max / ave: the
Profiling Report) and open a ``torch.profiler.record_function`` range of
the same name, so the names show in PyTorch's trace next to the kernels
they launched.  A range opens while this profiler runs or while any
``torch.profiler.profile`` records (``tools/profile_gpt.py`` opens its
own), and costs nothing otherwise.

``start_profiler`` with a state other than ``"CPU"`` runs
``torch.profiler.profile`` over the CPU and CUDA activities (CUPTI: the
reference's ``jax.profiler`` trace) and ``stop_profiler`` exports its
chrome trace as ``device_trace.<pid>.json`` under ``trace_dir``.  Where
the reference swallows a device trace that fails to start, the port
raises: a device state on a machine with no card raises the
``RuntimeError`` of ``device.resolve_device``.  ``export_chrome_tracing``
writes the host spans alone (the reference's timeline.py role), bounded
by ``FLAGS_profiler_max_spans``.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["RecordEvent", "record_event", "start_profiler", "stop_profiler",
           "reset_profiler", "profiler", "export_chrome_tracing",
           "is_profiling"]

_state = {
    "on": False,
    "device": None,          # the running torch.profiler.profile
    "trace_dir": None,
}
_lock = threading.Lock()
# name -> [calls, total, min, max] running aggregates (seconds; calls is
# an int): O(1) memory per distinct name, however long the run
_events: Dict[str, list] = {}
_spans: List[tuple] = []                      # (name, tid, t0, t1)
_dropped = [0]                                # spans over the retention cap
_t_start = [0.0]


def _max_spans() -> int:
    """Retention cap of the chrome-trace span list (the aggregate table
    is O(names) regardless): FLAGS_profiler_max_spans."""
    from paddle_tpu_torch.framework.flags import flag
    return int(flag("profiler_max_spans"))


def _tmp(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def is_profiling() -> bool:
    return _state["on"]


class RecordEvent:
    """Named host span (the reference's platform/profiler.h:127).  Usable
    as a context manager or decorator.  Opens a ``record_function`` range
    while any profiler records; aggregates host wall time only while this
    profiler is on."""

    def __init__(self, name: str):
        self.name = name
        self._range = None
        self._t0 = 0.0

    def __enter__(self):
        if _state["on"] or torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if _state["on"]:
            dur = t1 - self._t0
            with _lock:
                e = _events.get(self.name)
                if e is None:
                    _events[self.name] = [1, dur, dur, dur]
                else:
                    e[0] += 1
                    e[1] += dur
                    if dur < e[2]:
                        e[2] = dur
                    if dur > e[3]:
                        e[3] = dur
                # the aggregate counts every event; only the timeline is
                # bounded
                if len(_spans) < _max_spans():
                    _spans.append((self.name, threading.get_ident(),
                                   self._t0, t1))
                else:
                    _dropped[0] += 1
        return False

    def __call__(self, fn):
        def wrapped(*a, **k):
            with RecordEvent(self.name):
                return fn(*a, **k)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


@contextlib.contextmanager
def record_event(name: str):
    """fluid/profiler.py record_event (the context-manager form)."""
    with RecordEvent(name):
        yield


def reset_profiler():
    """fluid/profiler.py:109."""
    with _lock:
        _events.clear()
        _spans.clear()
        _dropped[0] = 0
    _t_start[0] = time.perf_counter()


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   trace_dir: Optional[str] = None):
    """fluid/profiler.py:131.  ``state``: ``"CPU"`` = host spans only;
    ``"GPU"`` / ``"TPU"`` / ``"All"`` = also PyTorch's profiler over the
    CPU and CUDA activities, its chrome trace written under ``trace_dir``
    (default ``<tmpdir>/paddle_tpu_torch_profile``) at
    :func:`stop_profiler`.  Raises without a card (no fallback)."""
    if state not in ("CPU", "GPU", "TPU", "All"):
        raise ValueError("state must be 'CPU', 'GPU', 'TPU' or 'All'")
    if tracer_option not in ("Default", "OpDetail", "AllOpDetail"):
        raise ValueError("tracer_option must be 'Default', 'OpDetail' "
                         "or 'AllOpDetail'")
    prof = None
    _state["trace_dir"] = None
    if state != "CPU":
        from paddle_tpu_torch.device import resolve_device
        resolve_device("cuda")
        d = trace_dir or _tmp("paddle_tpu_torch_profile")
        os.makedirs(d, exist_ok=True)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        _state["trace_dir"] = d
    reset_profiler()
    _state["device"] = prof
    _state["on"] = True


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None):
    """fluid/profiler.py:198: stop, export the device trace (when one
    ran), write the host spans to ``profile_path`` (default
    ``<tmpdir>/profile``) as chrome-trace JSON, and print the Profiling
    Report."""
    if not _state["on"]:
        return
    prof = _state["device"]
    if prof is not None:
        prof.stop()
        _state["device"] = None
        prof.export_chrome_trace(os.path.join(
            _state["trace_dir"], f"device_trace.{os.getpid()}.json"))
    _state["on"] = False
    export_chrome_tracing(profile_path)
    _print_report(sorted_key)


def _print_report(sorted_key):
    if sorted_key not in (None, "calls", "total", "max", "min", "ave"):
        raise ValueError("sorted_key must be one of None/'calls'/'total'/"
                         "'max'/'min'/'ave'")
    with _lock:
        rows = []
        grand = 0.0
        for name, (calls, tot, mn, mx) in _events.items():
            grand += tot
            rows.append((name, calls, tot * 1e3, mn * 1e3,
                         mx * 1e3, tot / calls * 1e3))
        dropped = _dropped[0]
    keyi = {"calls": 1, "total": 2, "min": 3, "max": 4, "ave": 5}
    if sorted_key:
        rows.sort(key=lambda r: r[keyi[sorted_key]], reverse=True)
    print("------------------------->     Profiling Report     "
          "<-------------------------\n")
    print("Place: {}\nTime unit: ms\nSorted by {} in descending order in "
          "the same thread\n".format(
              "GPU" if _state["trace_dir"] else "CPU",
              sorted_key or "first end time"))
    hdr = f"{'Event':<32}{'Calls':>8}{'Total':>12}{'Min.':>10}" \
          f"{'Max.':>10}{'Ave.':>10}{'Ratio.':>10}"
    print(hdr)
    for name, calls, tot, mn, mx, ave in rows:
        ratio = tot / (grand * 1e3) if grand else 0.0
        print(f"{name:<32}{calls:>8}{tot:>12.4f}{mn:>10.4f}{mx:>10.4f}"
              f"{ave:>10.4f}{ratio:>10.6f}")
    if dropped:
        print(f"\n{dropped} span(s) dropped from the timeline "
              f"(FLAGS_profiler_max_spans={_max_spans()}); the "
              "aggregates above still count every event")
    if _state["trace_dir"]:
        print(f"\nDevice trace (chrome trace of torch.profiler): "
              f"{_state['trace_dir']}")


def export_chrome_tracing(path: Optional[str] = None):
    """Write the host RecordEvent spans as chrome://tracing JSON (the
    reference's tools/timeline.py role) to ``path`` (default
    ``<tmpdir>/profile``)."""
    path = path or _tmp("profile")
    with _lock:
        spans = list(_spans)
        dropped = _dropped[0]
    t0 = _t_start[0]
    events = [{"name": name, "ph": "X", "pid": 0, "tid": tid,
               "ts": (a - t0) * 1e6, "dur": (b - a) * 1e6,
               "cat": "host"} for name, tid, a, b in spans]
    payload = {"traceEvents": events, "displayTimeUnit": "ms",
               "metadata": {"dropped_spans": dropped,
                            "max_spans": _max_spans()}}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: Optional[str] = None,
             tracer_option: str = "Default", trace_dir: Optional[str] = None):
    """fluid/profiler.py:255 (the context-manager form)."""
    start_profiler(state, tracer_option, trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
