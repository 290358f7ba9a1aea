"""Shared set-up of the host planes' port tests (``test_torch_monitor_locks``,
``test_torch_chaos``, ``test_torch_observability``, ``test_torch_health``,
``test_torch_profiler``): the two packages' planes side by side, and a
context that gives both a clean slate (empty statistics and histograms,
disarmed chaos seeded 0, no detectors or compile sites, an empty flight
ring) and puts back what the test found."""
import contextlib
import os
import sys
from types import SimpleNamespace

from paddle_tpu.framework import chaos as jchaos
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import health as jhealth
from paddle_tpu.framework import locks as jlocks
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.framework import observability as jobs
import paddle_tpu.profiler as jprof
from paddle_tpu_torch.framework import chaos as tchaos
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import health as thealth
from paddle_tpu_torch.framework import locks as tlocks
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.framework import observability as tobs
import paddle_tpu_torch.profiler as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

REF = SimpleNamespace(monitor=jmonitor, locks=jlocks, chaos=jchaos,
                      obs=jobs, health=jhealth, profiler=jprof, flags=jflags)
PORT = SimpleNamespace(monitor=tmonitor, locks=tlocks, chaos=tchaos,
                       obs=tobs, health=thealth, profiler=tprof, flags=tflags)
BOTH = (REF, PORT)


@contextlib.contextmanager
def clean_planes(flags=None):
    """Both packages' planes emptied for the block (``flags`` set in both
    registries) and restored after it."""
    saved = []
    for pkg in BOTH:
        reg = pkg.monitor.StatRegistry.instance()
        saved.append((dict(reg._stats), dict(pkg.monitor._hists),
                      pkg.flags.get_flags(list(flags or ()))))
        reg._stats.clear()
        pkg.monitor._hists.clear()
        pkg.chaos.reset(0)
        pkg.health.reset()
        pkg.obs.flight.clear()
        if flags:
            pkg.flags.set_flags(dict(flags))
    try:
        yield
    finally:
        for pkg, (stats, hists, fl) in zip(BOTH, saved):
            reg = pkg.monitor.StatRegistry.instance()
            reg._stats.clear()
            reg._stats.update(stats)
            pkg.monitor._hists.clear()
            pkg.monitor._hists.update(hists)
            pkg.chaos.reset(0)
            pkg.health.reset()
            pkg.obs.flight.clear()
            if fl:
                pkg.flags.set_flags(fl)
