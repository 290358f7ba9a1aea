"""Replay an incident bundle (port of tools/replay.py).

    python -m paddle_tpu_torch.tools.replay <bundle> [--bisect]
                                            [--ledger PATH]

The bundle is a directory ``incident_<NNNNNN>/`` that
``framework/incident.py`` wrote when a subscribed flight event fired.
The tool verifies it (a torn bundle is refused: ``REPLAY_REFUSED``),
re-arms the recorded flag overrides (never the capture plane's own
flags), rebuilds the step from the bundle's program descriptor
(``incident.set_program("module:function", **kwargs)``), restores the
recorded state (the inline state, or the referenced checkpoint
generation, which must still exist and verify:
``REPLAY_MISSING_GENERATION`` otherwise) and re-feeds the ringed inputs
with each entry's random state put back.

* default: re-arm the recorded chaos schedule and require the recorded
  flight kind (and its ``first_bad_leaf``) to fire again:
  ``REPLAY_REPRODUCED`` (exit 0) or ``REPLAY_NOT_REPRODUCED`` (exit 1);
* ``--bisect``: chaos disarmed, compare each re-run step's state hashes
  with the recorded trajectory; the first mismatch is the step whose
  recorded run took the fault: ``BISECT_DIVERGENCE step=<n> leaf=<name>``
  (exit 0), or ``BISECT_CLEAN`` (exit 1).

``--ledger`` appends the verdict to a run ledger (``kind=
incident_replay``).  The step runs where its builder puts it: on the card
unless the builder asks for the CPU.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys

__all__ = ["load_bundle", "build_program", "restore_state",
           "apply_recorded_flags", "replay_signal", "bisect_ring", "main"]

#: flags a replay does not take from the bundle: the capture plane's own
#: (a replay never captures its own incidents), the original run's
#: producer paths, and the chaos flags (chaos.restore_state owns the
#: schedule)
_FLAG_SKIP = {"incident", "incident_dir", "incident_kinds", "runlog_dir",
              "trace_dir", "flight_dir", "collector_endpoint",
              "chaos_spec", "chaos_seed"}


def load_bundle(path: str) -> dict:
    """Verify and read one bundle; ``SystemExit(2)`` with the refusal
    line on a torn directory."""
    from paddle_tpu_torch.framework import incident
    problems = incident.verify_bundle(path)
    if problems:
        reasons = "; ".join(f"{p.get('file')}: {p.get('reason')}"
                            for p in problems[:4])
        print(f"REPLAY_REFUSED bundle={path} problems={reasons}")
        raise SystemExit(2)
    return incident.read_manifest(path)


def apply_recorded_flags(manifest: dict) -> None:
    """Re-arm the recorded flag overrides (not the capture plane's, and
    not unknown names), then turn the incident plane off here."""
    from paddle_tpu_torch.framework import flags
    for name, value in (manifest.get("flags_overrides") or {}).items():
        if name in _FLAG_SKIP:
            continue
        try:
            flags.set_flags({name: value})
        except ValueError:
            print(f"replay: skipping unknown recorded flag {name!r}",
                  file=sys.stderr)
    flags.set_flags({"incident": False})


def build_program(manifest: dict):
    """Rebuild the step from the bundle's program descriptor."""
    prog = manifest.get("program")
    if not prog or not prog.get("builder"):
        print("REPLAY_REFUSED no program descriptor in bundle (the "
              "recording process never called incident.set_program)")
        raise SystemExit(2)
    mod_name, _, fn_name = str(prog["builder"]).partition(":")
    try:
        builder = getattr(importlib.import_module(mod_name), fn_name)
    except (ImportError, AttributeError) as e:
        print(f"REPLAY_REFUSED builder {prog['builder']!r} not "
              f"importable: {e!r}")
        raise SystemExit(2)
    return builder(**(prog.get("kwargs") or {}))


def restore_state(step, manifest: dict, bundle: str) -> None:
    """Restore the recorded state into the rebuilt step: the inline
    state, or the referenced generation, which must exist, be committed
    and verify (a collected generation fails by name rather than
    replaying from the builder's fresh state).  The state's global step
    must be the ring's first: a replay from any other skips or repeats
    steps."""
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.framework.incident import (STATE_DIRNAME,
                                                     train_surface)
    surface = train_surface(step)
    state = manifest.get("state") or {}
    if state.get("inline"):
        checkpoint.load_train_state(
            surface, os.path.join(bundle, state.get("dir") or STATE_DIRNAME))
        _require_ring_start(surface, manifest)
        return
    ref = state.get("ref")
    if not ref or ref.get("generation") is None:
        print("REPLAY_REFUSED bundle has neither inline state nor a "
              "checkpoint generation ref (state exceeded "
              "FLAGS_incident_state_cap_mb with no durable manager "
              "attached)")
        raise SystemExit(2)
    gen_name = f"gen_{int(ref['generation']):08d}"
    gen_dir = os.path.join(str(ref.get("root") or ""), gen_name)
    if not os.path.isdir(gen_dir) or not checkpoint.is_committed(gen_dir):
        print(f"REPLAY_MISSING_GENERATION {gen_name} root={ref.get('root')}"
              " (collected or never committed: refusing to replay from "
              "the wrong state)")
        raise SystemExit(2)
    problems = checkpoint.verify_checkpoint(gen_dir, deep=True)
    if problems:
        print(f"REPLAY_MISSING_GENERATION {gen_name} "
              f"root={ref.get('root')} (corrupt: "
              + "; ".join(sorted({p['reason'] for p in problems})) + ")")
        raise SystemExit(2)
    checkpoint.load_train_state(surface, gen_dir)
    _require_ring_start(surface, manifest)


def _require_ring_start(surface, manifest: dict) -> None:
    """Refuse a restored state whose global step is not the ring's
    first."""
    start = manifest["ring"][0]["step"]
    got = int(getattr(surface.optimizer, "_global_step", 0))
    if got != int(start):
        print(f"REPLAY_REFUSED restored state is at step {got}, the ring "
              f"starts at step {start} (replaying would skip or repeat "
              "steps)")
        raise SystemExit(2)


def _device_of(step):
    from paddle_tpu_torch.framework.incident import _step_device
    return _step_device(step)


def _run_ring(step, manifest: dict, bundle: str):
    """Re-run every ringed step with its random state put back; yields
    (entry, loss)."""
    import torch
    from paddle_tpu_torch.framework import incident
    dev = _device_of(step)
    for entry in manifest.get("ring", []):
        loaded = incident.load_ring_entry(bundle, entry)
        args = [torch.from_numpy(arr) if kind == "tensor" else arr
                for kind, arr in loaded["inputs"]]
        if loaded["rng"] is not None:
            incident.restore_rng(loaded["rng"], dev)
        yield entry, step(*args)


def replay_signal(step, manifest: dict, bundle: str) -> dict:
    """The reproduction check: re-arm the recorded chaos schedule, re-run
    the ring, and require the recorded flight kind (and its
    ``first_bad_leaf``) to fire again."""
    from paddle_tpu_torch.framework import chaos
    from paddle_tpu_torch.framework.observability import flight
    chaos.restore_state(manifest.get("chaos") or {})
    event = manifest.get("event") or {}
    want_kind = event.get("kind")
    want_leaf = (event.get("attrs") or {}).get("first_bad_leaf")
    seq0 = flight.last_seq()
    for _entry, _loss in _run_ring(step, manifest, bundle):
        pass
    got_kind = got_leaf = None
    for ev in flight.since(seq0, limit=1024):
        if ev.get("kind") == want_kind:
            got_kind = ev["kind"]
            got_leaf = (ev.get("attrs") or {}).get("first_bad_leaf")
            break
    reproduced = got_kind == want_kind and \
        (want_leaf is None or got_leaf == want_leaf)
    return {"reproduced": bool(reproduced), "kind": want_kind,
            "recorded_first_bad_leaf": want_leaf,
            "replayed_first_bad_leaf": got_leaf}


def bisect_ring(step, manifest: dict, bundle: str) -> dict:
    """The counterfactual walk: chaos disarmed, re-run the ring and
    compare each step's state hashes with the recorded trajectory; the
    first mismatch is the step whose recorded run took the fault."""
    from paddle_tpu_torch.framework import chaos, incident
    chaos.reset()
    trajectory = manifest.get("trajectory") or []
    post = manifest.get("post_hashes")
    ring = manifest.get("ring", [])
    i = 0
    for entry, _loss in _run_ring(step, manifest, bundle):
        expected = trajectory[i + 1].get("pre_hashes") \
            if i + 1 < len(trajectory) else post
        i += 1
        if not expected:
            continue
        live = incident.hash_step_state(step)
        for leaf in sorted(expected):
            if live.get(leaf) != int(expected[leaf]):
                return {"divergent_step": entry.get("step"),
                        "leaf": leaf, "entries_walked": i,
                        "entries_total": len(ring)}
    return {"divergent_step": None, "leaf": None,
            "entries_walked": i, "entries_total": len(ring)}


def _write_verdict(ledger_path: str, manifest: dict, verdict: dict):
    from paddle_tpu_torch.framework import runlog
    rec = runlog.capture(
        kind="incident_replay",
        label=(manifest.get("event") or {}).get("kind"),
        include_snapshot=False,
        extra={"replay_verdict": dict(verdict,
                                      id=manifest.get("incident_id"))})
    runlog.RunLedger(ledger_path).append(rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.tools.replay", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("bundle", help="incident bundle directory "
                                   "(incident_<NNNNNN>/)")
    ap.add_argument("--bisect", action="store_true",
                    help="the first-divergence walk with chaos disarmed "
                         "instead of the signal replay")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="append the verdict to this run ledger "
                         "(kind=incident_replay)")
    a = ap.parse_args(argv)

    bundle = os.path.abspath(a.bundle)
    manifest = load_bundle(bundle)
    iid = manifest.get("incident_id")
    if not manifest.get("ring"):
        print(f"REPLAY_REFUSED incident {iid}: empty input ring, nothing "
              "to re-run")
        return 2
    apply_recorded_flags(manifest)
    step = build_program(manifest)
    restore_state(step, manifest, bundle)

    if a.bisect:
        verdict = bisect_ring(step, manifest, bundle)
        verdict["mode"] = "bisect"
        if a.ledger:
            _write_verdict(a.ledger, manifest, verdict)
        if verdict["divergent_step"] is None:
            print(f"BISECT_CLEAN incident={iid} "
                  f"entries={verdict['entries_total']}")
            return 1
        print(f"BISECT_DIVERGENCE step={verdict['divergent_step']} "
              f"leaf={verdict['leaf']} incident={iid}")
        return 0

    verdict = replay_signal(step, manifest, bundle)
    verdict["mode"] = "replay"
    if a.ledger:
        _write_verdict(a.ledger, manifest, verdict)
    if verdict["reproduced"]:
        print(f"REPLAY_REPRODUCED kind={verdict['kind']} "
              f"first_bad_leaf={verdict['recorded_first_bad_leaf']} "
              f"incident={iid}")
        return 0
    print(f"REPLAY_NOT_REPRODUCED kind={verdict['kind']} "
          f"recorded={verdict['recorded_first_bad_leaf']} "
          f"replayed={verdict['replayed_first_bad_leaf']} incident={iid}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
