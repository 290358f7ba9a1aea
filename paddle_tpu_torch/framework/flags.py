"""Typed global flag registry (port of paddle_tpu/framework/flags.py).

Only the registry and the flags the ported path reads live here.  Flags
are env-seeded (``FLAGS_<name>``) and readable/writable at run time.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["define_flag", "flag", "get_flags", "set_flags", "overrides"]

_registry: Dict[str, Any] = {}
_defaults: Dict[str, Any] = {}
_lock = threading.Lock()


def define_flag(name: str, default, help_str: str = ""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    with _lock:
        _registry[name] = value
        _defaults[name] = default
    return value


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _registry:
        raise ValueError(f"unknown flag {name}")
    return key


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    return {n: _registry[_key(n)] for n in names}


def set_flags(flags: dict):
    for n, v in flags.items():
        key = _key(n)
        with _lock:
            _registry[key] = v


def flag(name: str):
    return _registry[name]


def overrides() -> Dict[str, Any]:
    """Every flag whose value differs from its registered default, set
    from the environment or at run time (reference ``flags.overrides``):
    what the run ledger and the incident bundles stamp."""
    with _lock:
        return {n: v for n, v in _registry.items()
                if n in _defaults and v != _defaults[n]}


define_flag("gpt_fused_ce", False,
            "route gpt_loss through the fused linear+cross-entropy kernel "
            "(ops/cuda/fused_ce.py): the (B, S, V) logits never reach "
            "device memory")
define_flag("zero_wire_dtype", "bf16",
            "wire encoding of the ZeRO sharded-update collectives "
            "(parallel/zero.py ShardedUpdateTrainStep reduce-scatter and "
            "all-gather legs): 'bf16' (half the f32 bytes), 'int8' (a "
            "quarter, plus one f32 scale a chunk), 'int4' (an eighth, "
            "packed nibbles plus one scale a chunk) or 'f32' (the exact "
            "leg).  The default of ShardedUpdateTrainStep(wire_dtype=None), "
            "kept as the reference's name for it; callers pass wire_dtype")
define_flag("zero_ring_collectives", False,
            "run the dp collective legs as the quantized ring "
            "(parallel/ring.py): one neighbour hop a step, the encode and "
            "decode between hops.  ShardedUpdateTrainStep and "
            "CompressedAllReduceTrainStep; the f32 wire keeps the plain "
            "collectives.  The default of ring=None, kept as the "
            "reference's name for it; callers pass ring")
define_flag("check_nan_inf", False,
            "jit.TrainStep (__call__ and multi_step) raises "
            "FloatingPointError on a non-finite loss: before any state is "
            "left changed without donation, after the write-back with it.  "
            "One read of the losses from the device a call when armed, "
            "none when not")
define_flag("ps_prefetch_depth", 1,
            "max in-flight prefetched pulls in PSTrainStep's pipeline "
            "(distributed/ps PSTrainStep.prefetch): 0 disables the "
            "pipeline, 1 is the double buffer: the next batch's pull runs "
            "on a background thread while the card runs the current step, "
            "after the previous step's push")
define_flag("ps_hot_row_k", 0,
            "bounded top-k hot-row sketch per host embedding table "
            "(space-saving counters over pulled ids, "
            "distributed/ps/device_table.py HotRowSketch); 0 disables it")

# the parameter server's TCP transport (distributed/ps/service.py)
define_flag("ps_rpc_timeout", 30.0,
            "socket timeout (s) of one PS RPC")
define_flag("ps_rpc_max_retries", 3,
            "retries of a PS RPC after a transport failure before its "
            "endpoint is reported dead")
define_flag("ps_rpc_backoff_base", 0.05,
            "exponential backoff base (s): sleep base * 2^attempt between "
            "PS RPC retries")
define_flag("ps_wire_dtype", "bf16",
            "encoding of the PS pull rows and push gradients: 'bf16' (half "
            "the f32 bytes), 'int8' (a quarter, one f32 scale a row), "
            "'int4' (an eighth, packed nibbles and one scale a row) or "
            "'f32' (exact).  Negotiated a peer at a time: a pull decodes "
            "what its reply declares, int4 pulls and every quantized push "
            "wait for a hello handshake listing the dtype, so a server "
            "that predates it keeps the link at f32")
define_flag("collector_endpoint", "",
            "host:port of the cluster telemetry collector "
            "(framework/collector.py CollectorServer); "
            "PADDLE_COLLECTOR_ENDPOINT takes precedence.  Non-empty arms "
            "collector.auto_reporter(): the process pushes "
            "monitor.snapshot() deltas and flight-event deltas, fire and "
            "forget (bounded queue, drop counter, collector.rpc chaos "
            "point).  The launcher exports it to every child")
define_flag("collector_interval", 5.0,
            "seconds between telemetry pushes to the collector "
            "(MetricsReporter push mode / collector.auto_reporter)")
define_flag("collector_queue_capacity", 64,
            "bound on the collector push queue: a payload enqueued while "
            "the queue is full is dropped and counted "
            "(collector_dropped_total)")
define_flag("collector_timeout", 2.0,
            "socket timeout (s) of one collector push attempt; a timed-out "
            "push is a drop, never a retry")
define_flag("collector_straggler_ratio", 2.0,
            "straggler threshold: a worker whose per-interval step mean "
            "exceeds this multiple of the cluster median is named a "
            "straggler in the collector's view")

# the host planes (framework/{chaos,observability,locks,health}.py and
# profiler): the reference's names, defaults and environment seeding
define_flag("chaos_spec", "",
            "JSON {fault_point: schedule} armed into framework.chaos at "
            "first use, e.g. '{\"zero.collective\": {\"mode\": \"error\", "
            "\"nth\": 1}}'.  The environment form arms a whole tree of "
            "child processes; empty = chaos off")
define_flag("chaos_seed", 0,
            "seed of the chaos probability schedules")
define_flag("trace_dir", "",
            "directory of the distributed-tracing span files; non-empty "
            "enables the process-wide Tracer, which appends finished spans "
            "to trace_<label>.jsonl there (label from PADDLE_TRACE_LABEL)")
define_flag("trace_max_mb", 0.0,
            "size cap (MB) of a span-file segment: past it the segment "
            "rotates to trace_<label>.jsonl.1 (one previous segment kept) "
            "and a fresh one opens; 0 = unbounded")
define_flag("flight_capacity", 512,
            "flight recorder ring size: the last N structured events kept "
            "for crash dumps")
define_flag("flight_dir", "",
            "directory of flight_<worker>.json crash dumps "
            "(install_crash_handler); empty = the current directory")
define_flag("metrics_export_interval", 30.0,
            "seconds between MetricsReporter writes of "
            "monitor.export_prometheus() to its file (tmp + rename)")
define_flag("lock_watchdog", False,
            "arm the runtime lock-order watchdog over every tracked lock "
            "(framework/locks.py): held-before graph, locks.cycle and "
            "locks.long_hold flight events, lock_waits_total and "
            "lock_hold_ms.  Off: one flag read per acquire")
define_flag("lock_hold_warn_ms", 1000.0,
            "hold time (ms) past which an armed watchdog records "
            "locks.long_hold on release; 0 disables the check")
define_flag("health_detectors", "",
            "streaming anomaly detectors (framework/health.py): '' = off, "
            "'default' arms the built-in signal set, or a JSON object "
            "'{\"signal\": {detector kwargs}}'")
define_flag("health_warmup", 16,
            "baseline samples a health.Detector collects before it scores")
define_flag("health_z_threshold", 8.0,
            "robust MAD z-score at which a health.Detector flags an "
            "anomaly")
define_flag("health_compile_warmup_calls", 10,
            "calls per compile site within which a new signature counts as "
            "warm-up; past it a recompile is steady-state "
            "(jit_recompiles_steady_total)")
define_flag("health_compile_storm_k", 3,
            "post-warm-up recompiles at one site that make a compile storm "
            "(health.compile_storm flight event)")
define_flag("health_mem_sample_every", 0,
            "sample the device memory into the device_mem_* gauges every N "
            "train steps (health.MemoryTracker); 0 disables the per-step "
            "hook")
define_flag("numerics", False,
            "arm the model-numerics plane: TrainStep, PSTrainStep and "
            "ShardedUpdateTrainStep compute per-leaf and global grad / "
            "param norms, update ratios, max-abs and non-finite counts on "
            "the device and publish them as monitor gauges / histograms "
            "and health signals.  Off (default): the steps do no extra "
            "work and no extra synchronisation")
define_flag("numerics_sample_every", 10,
            "per-leaf numerics export cadence: the numerics_*[<leaf>] "
            "gauges refresh every Nth published step and on every "
            "non-finite step (when > 0); 0 turns the per-leaf export off, "
            "the global gauges and histograms still publish every step")
define_flag("ingest_prefetch_depth", 1,
            "max in-flight batches in IngestPipeline's double buffer "
            "(fetch and copy to the device on a background executor while "
            "the device runs the current step); 0 disables the overlap, 1 "
            "is the classic double buffer")
define_flag("ingest_cache_mode", "",
            "decoded-sample cache for epoch >= 2: '' (off), 'memory' "
            "(bounded in-RAM dict), or 'disk' (one crash-safe tmp+rename "
            "file per sample under FLAGS_ingest_cache_dir)")
define_flag("ingest_cache_dir", "",
            "directory of the disk-backed decoded-sample cache; empty = an "
            "'ingest_cache' dir under the current directory")
define_flag("ingest_cache_bytes", 1 << 30,
            "byte bound on the decoded-sample cache (memory or disk): "
            "inserts stop once the recorded payload bytes reach it")
define_flag("ckpt_keep_last", 2,
            "checkpoint generations the GC always keeps (newest first); "
            "the newest verified commit is kept on top of this")
define_flag("ckpt_keep_every", 0,
            "additionally keep every Nth generation (by generation "
            "number) as a long-horizon archive; 0 disables")
define_flag("numerics_scale_collapse_k", 4,
            "consecutive GradScaler downscales that make a loss-scale "
            "collapse: a numerics.scale_collapse flight event every K "
            "consecutive decreases")
define_flag("flight_storm_window", 1.0,
            "seconds within which identical (kind, attrs) flight events "
            "are deduplicated once flight_storm_k of them landed; 0 "
            "disables the guard")
define_flag("flight_storm_k", 8,
            "identical (kind, attrs) flight events tolerated per "
            "flight_storm_window before further ones are suppressed")
define_flag("ckpt_emergency_deadline", 10.0,
            "seconds a SIGTERM emergency callback (observability."
            "on_sigterm) may take before the handler goes on to the crash "
            "dump")
define_flag("profiler_max_spans", 100000,
            "cap on the host spans a profiling session keeps for its chrome "
            "trace; past it spans are dropped and counted while the "
            "aggregate report counts every event")

# the operations planes (parallel/parity.py, framework/{runlog,autopilot,
# incident}.py): the reference's names, defaults and environment seeding
define_flag("replica_parity", False,
            "arm the replica-parity probe: the train-step classes hash "
            "every replicated parameter and optimizer-state leaf bitwise "
            "on each replica every FLAGS_replica_parity_every steps and "
            "compare the hashes across the dp axis; a divergent leaf fires "
            "a parity.divergence flight event naming the first one and "
            "counts parity_divergence_total.  The probe never raises.  "
            "Off: one flag lookup a step")
define_flag("replica_parity_every", 16,
            "replica-parity probe cadence: hash-compare the replicated "
            "state every Nth step of each armed train-step object")
define_flag("runlog_dir", "",
            "directory of the persistent run ledger "
            "(<runlog_dir>/ledger.jsonl, append-only JSONL).  Non-empty "
            "arms the implicit producers: TrainEpochRange appends a run "
            "record when an epoch range completes.  Empty = off")
define_flag("autopilot", False,
            "arm the runtime autopilot controller (framework/autopilot.py):"
            " telemetry the planes publish maps through the policy table "
            "onto the bounded actuators (prefetch depth, wire dtype, "
            "GradScaler growth, snapshot and restore, straggler shrink).  "
            "Off: attach() returns None")
define_flag("autopilot_dry_run", False,
            "autopilot decisions are logged (flight events and ledger "
            "action records) but no actuator fires: the trajectory is "
            "bitwise that of an autopilot-off run")
define_flag("autopilot_interval_steps", 8,
            "steps between autopilot evaluation intervals")
define_flag("autopilot_hysteresis", 2,
            "consecutive confirming evaluation intervals before a policy's "
            "action fires (per-policy override in the policy table)")
define_flag("autopilot_cooldown_s", 30.0,
            "per-action cooldown: after an actuator fires (or is "
            "reverted) the same action is suppressed this many seconds")
define_flag("autopilot_max_actions", 4,
            "global action budget: at most this many actions a "
            "autopilot_window_s rolling window; excess decisions are "
            "suppressed (reason='budget')")
define_flag("autopilot_window_s", 300.0,
            "rolling window (s) of the autopilot_max_actions budget")
define_flag("autopilot_rollback_intervals", 1,
            "evaluation intervals after an action before the rollback "
            "guard re-measures its objective and reverts an action that "
            "made things worse")
define_flag("autopilot_rollback_tolerance", 0.25,
            "relative objective worsening the rollback guard tolerates "
            "before reverting; any anomaly or NaN-rate increase reverts "
            "regardless")
define_flag("autopilot_max_prefetch_depth", 4,
            "ceiling the prefetch.deepen actuator never pushes "
            "PSTrainStep.prefetch_depth past")
define_flag("autopilot_straggler_deadline", 60.0,
            "seconds a collector-flagged straggler must stay flagged "
            "before the elastic.shrink actuator may invoke "
            "ElasticAgent.enforce_straggler_policy")
define_flag("autotune_profile", "",
            "path of a tuned-knob profile JSON; non-empty makes TrainStep "
            "and PSTrainStep apply the profile's knobs (ps_prefetch_depth, "
            "ps_wire_dtype, zero_wire_dtype) through set_flags once a "
            "process at the first step construction.  A missing or "
            "corrupt profile is a counted autopilot.profile_error flight "
            "event, never a crash")
define_flag("incident", False,
            "arm the postmortem plane: ResilientTrainStep and PSTrainStep "
            "keep a host ring of recent step inputs, rng state, pre-step "
            "training state and chaos schedule, and a subscribed flight "
            "kind (FLAGS_incident_kinds) firing writes a crash-safe "
            "incident bundle under FLAGS_incident_dir that "
            "paddle_tpu_torch/tools/replay.py re-executes.  Capture never "
            "raises and never changes the trajectory.  Off: one flag "
            "lookup a step")
define_flag("incident_kinds", "",
            "comma-separated flight kinds that trigger incident capture; "
            "empty = the built-in subscription (train.nan_skip, "
            "health.anomaly, numerics.scale_collapse, parity.divergence, "
            "pallas.divergence, autopilot.action, autopilot.revert)")
define_flag("incident_dir", "",
            "directory incident bundles land under (incident_<NNNNNN>/ a "
            "capture); empty = 'incidents' under the current directory")
define_flag("incident_ring", 4,
            "steps of input history the armed IncidentRecorder keeps; the "
            "bundle replays this window and --bisect walks it")
define_flag("incident_state_cap_mb", 64.0,
            "inline-state size cap (MB) of an incident bundle: below it "
            "the ring's oldest pre-step state is embedded; above it the "
            "bundle records a {root, generation} reference to the newest "
            "verified checkpoint generation.  0 forces the reference")
