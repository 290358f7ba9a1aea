"""Multi-generation durable checkpoint store (port of
paddle_tpu/distributed/durable.py).

The layer the ROADMAP's "safe to run indefinitely" item needs under the
recovery paths: ``distributed/checkpoint.py`` persists ONE directory and
verifies it; this module owns a *root* of generation directories

    <root>/gen_00000042/   (shards + metadata.json + COMMIT)
    <root>/gen_00000084/
    ...

and the policy around them:

* **save** — sync or async (``checkpoint.save_train_state``), always
  commit-after-verify: the ``COMMIT`` marker lands strictly last, only
  once every shard re-reads intact, so the newest committed generation
  is by construction loadable.
* **restore** — generation walk, newest first: a generation without a
  COMMIT marker (mid-save, torn, or killed) is skipped silently; a
  committed generation that fails verification fires ``ckpt.corrupt``
  (via verify) plus a ``ckpt.fallback`` flight event and the walk
  continues to the next older one.  Training resumes from the newest
  state that provably survives re-reading — never crashes on, never
  silently loads, garbage.
* **GC** — ``FLAGS_ckpt_keep_last`` newest generations are kept, plus
  every ``FLAGS_ckpt_keep_every``-th by generation number (long-horizon
  archive), and the newest *verified* commit is kept unconditionally;
  only generations strictly OLDER than that verified commit are ever
  deleted, so retention can never destroy the only restorable state.
* **preemption** — ``arm_emergency_save`` registers a deadline-bounded
  SIGTERM callback (``observability.on_sigterm``): the grace window the
  elastic agent grants (``ElasticAgent(term_grace=...)``) is spent
  fencing any in-flight async write and committing one final
  generation.

The reference's offline tool ``tools/ckpt_check.py`` (verify / list /
gc) reads the same layout.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional, Tuple

from paddle_tpu_torch.distributed import checkpoint
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.flags import flag
from paddle_tpu_torch.framework.observability import flight

__all__ = ["CheckpointManager", "generation_dirs"]

_GEN_RE = re.compile(r"^gen_(\d{8,})$")


def generation_dirs(root: str) -> List[Tuple[int, str]]:
    """(generation, dirpath) pairs under ``root``, ascending by
    generation.  Non-generation entries are ignored — the layout is
    shared with humans and tools that may drop other files there."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        m = _GEN_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort()
    return out


class CheckpointManager:
    """Policy layer over a root of ``gen_<NNNNNNNN>`` checkpoint
    directories: verified commits, newest-verified generation walk,
    bounded retention, and the SIGTERM emergency save."""

    def __init__(self, root: str, keep_last: Optional[int] = None,
                 keep_every: Optional[int] = None):
        self.root = root
        self._keep_last = keep_last
        self._keep_every = keep_every
        os.makedirs(root, exist_ok=True)

    # -- layout ------------------------------------------------------------

    def generation_dir(self, generation: int) -> str:
        return os.path.join(self.root, f"gen_{int(generation):08d}")

    def generations(self) -> List[int]:
        """All generation numbers present (committed or not), ascending."""
        return [g for g, _ in generation_dirs(self.root)]

    @property
    def keep_last(self) -> int:
        v = self._keep_last if self._keep_last is not None \
            else flag("ckpt_keep_last")
        return max(1, int(v))

    @property
    def keep_every(self) -> int:
        v = self._keep_every if self._keep_every is not None \
            else flag("ckpt_keep_every")
        return max(0, int(v))

    # -- save --------------------------------------------------------------

    def save(self, step, generation: int, world_size: Optional[int] = None,
             mode: str = "sync"):
        """Persist one generation, commit-after-verify, then GC.

        ``mode="async"`` returns an :class:`checkpoint.AsyncSaveHandle`
        (GC runs on the background thread after the commit lands, so the
        train thread never pays for deletion either); sync returns None.
        Either way the COMMIT marker is written only after every shard
        verifies — a failed verify raises :class:`CheckpointVerifyError`
        (async: out of ``handle.wait()``) and leaves the generation
        uncommitted, where the walk ignores it and GC may reap it."""
        dirpath = self.generation_dir(generation)
        if mode == "async":
            handle = checkpoint.save_train_state(
                step, dirpath, global_step=generation,
                world_size=world_size, mode="async", commit=True)
            if handle is not None:
                # GC off the train thread too: a watcher waits for the
                # commit to land, then reaps (skipped when the write
                # failed — nothing new is committed, nothing to reap)
                import threading

                def _gc_when_done(h=handle):
                    try:
                        h.wait()
                    except BaseException:  # noqa: BLE001 — surfaced at wait()
                        return
                    self.gc(deep=False)

                threading.Thread(target=_gc_when_done, name="ckpt-gc",
                                 daemon=True).start()
                return handle
            # chaos ckpt.async degraded the save to sync: fall through
        else:
            checkpoint.save_train_state(
                step, dirpath, global_step=generation,
                world_size=world_size, mode="sync", commit=True)
        self.gc(deep=False)
        return None

    # -- restore -----------------------------------------------------------

    def latest_verified(self, deep: bool = True) -> Optional[int]:
        """Newest generation whose COMMIT marker exists AND whose shards
        verify — the generation walk.  Uncommitted directories (mid-save
        or torn) are skipped without ceremony; a committed-but-corrupt
        one fires ``ckpt.corrupt`` (inside verify) and a ``ckpt.fallback``
        flight event naming the skip, and the walk continues older."""
        for gen, dirpath in reversed(generation_dirs(self.root)):
            if not checkpoint.is_committed(dirpath):
                continue
            problems = checkpoint.verify_checkpoint(dirpath, deep=deep)
            if not problems:
                return gen
            monitor.stat_add("ckpt_fallback_total")
            flight.record("ckpt.fallback", severity="warn",
                          dir=dirpath, generation=gen,
                          reasons=sorted({p["reason"] for p in problems}))
        return None

    def restore(self, step, deep: bool = True) -> Optional[int]:
        """Load the newest verified generation into ``step`` (joining any
        in-flight async save first — it may BE the newest generation).
        Returns the restored generation number, or None when no
        generation verifies (fresh start)."""
        checkpoint.wait_pending_saves()
        gen = self.latest_verified(deep=deep)
        if gen is None:
            return None
        checkpoint.load_train_state(step, self.generation_dir(gen))
        return gen

    # -- retention ---------------------------------------------------------

    def gc(self, deep: bool = True) -> List[int]:
        """Delete generations the retention policy no longer needs.

        Kept unconditionally: the newest *verified* commit, the
        ``keep_last`` newest generations, and every ``keep_every``-th
        generation number.  Everything else strictly OLDER than the
        newest verified commit is deleted; anything newer is never
        touched (it may be an in-flight save).  Returns the deleted
        generation numbers.

        ``deep`` controls how the anchor commit is verified.  The
        default re-reads shards against their crc stamps so retention
        can never destroy the only restorable state even under
        post-commit bit-rot — the right mode for offline/cold callers
        (``tools/ckpt_check.py gc``, a fresh manager over an old root).
        The save path passes ``deep=False``: the commit it just landed
        was verify-gated moments ago, so an existence+size check keeps
        the hot path O(files) instead of O(bytes)."""
        gens = generation_dirs(self.root)
        if not gens:
            return []
        newest_verified = self.latest_verified(deep=deep)
        if newest_verified is None:
            return []            # nothing provably restorable: delete nothing
        keep = {g for g, _ in gens[-self.keep_last:]}
        keep.add(newest_verified)
        n = self.keep_every
        if n > 0:
            keep.update(g for g, _ in gens if g % n == 0)
        deleted = []
        for gen, dirpath in gens:
            if gen in keep or gen >= newest_verified:
                continue
            shutil.rmtree(dirpath, ignore_errors=True)
            deleted.append(gen)
        if deleted:
            monitor.stat_add("ckpt_gc_deleted_total", len(deleted))
            flight.record("ckpt.gc", generations=deleted,
                          kept_newest_verified=newest_verified)
        return deleted

    # -- preemption --------------------------------------------------------

    def arm_emergency_save(self, step, get_generation,
                           deadline: Optional[float] = None):
        """Register the SIGTERM emergency save (idempotent per root).

        On SIGTERM the crash-handler chain runs this callback bounded by
        ``deadline`` (``FLAGS_ckpt_emergency_deadline`` when None): it
        fences any in-flight async write, then saves + commits one final
        generation at ``get_generation()`` synchronously.  The elastic
        agent's ``term_grace`` is what makes the window exist; this is
        what spends it."""
        from paddle_tpu_torch.framework.observability import on_sigterm

        def emergency():
            checkpoint.wait_pending_saves()
            gen = int(get_generation())
            dirpath = self.generation_dir(gen)
            if checkpoint.is_committed(dirpath):
                return           # this generation already landed in full
            checkpoint.save_train_state(step, dirpath, global_step=gen,
                                        mode="sync", commit=True)
            monitor.stat_add("ckpt_emergency_saves_total")
            flight.record("ckpt.emergency_save", generation=gen,
                          dir=dirpath)

        on_sigterm(f"ckpt-emergency:{self.root}", emergency,
                   deadline=deadline)

    def disarm_emergency_save(self) -> bool:
        from paddle_tpu_torch.framework.observability import remove_sigterm_callback
        return remove_sigterm_callback(f"ckpt-emergency:{self.root}")
