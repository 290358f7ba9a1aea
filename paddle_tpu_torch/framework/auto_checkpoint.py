"""Auto-checkpoint / failure recovery — TrainEpochRange parity (port of
paddle_tpu/framework/auto_checkpoint.py).

Reference: python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py
(TrainEpochRange at :76, the ``for epoch in acp.train_epoch_range(N):``
loop protocol) — on every epoch boundary the trainer persists program
state + a status record; after a crash the relaunched job re-enters the
same loop and silently skips the epochs already done, restoring state.

Differences from the reference: state registration is explicit (a
TrainStep) instead of scraped from a global executor scope, storage is a
local/NFS directory instead of HDFS, and the state goes through
paddle_tpu_torch.distributed.checkpoint (each ZeRO rank writes only its
own shards).  Two checkpoint slots are alternated
(the reference's max_checkpoint_num=2 convention) so a crash mid-save
never corrupts the only copy.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Iterator, Optional

from paddle_tpu_torch.distributed import checkpoint as dckpt

__all__ = ["TrainEpochRange", "train_epoch_range", "latest_checkpoint"]

_STATUS = "acp_status.json"


def latest_checkpoint(checkpoint_dir: str, verify: bool = True):
    """The latest committed AND verified slot under a TrainEpochRange
    checkpoint directory: ``(slot_dir, epoch)``, or None when nothing
    restorable exists.  The status record is the two-slot protocol's
    commit point, so a mid-save (torn) slot is never returned — and
    since a disk can rot a slot AFTER its commit, the slot's shards are
    re-verified against their crc32 stamps here: a committed slot whose
    metadata parses but whose shard files are missing / truncated /
    bit-flipped fires ``ckpt.corrupt`` (inside verify) plus a
    ``ckpt.fallback`` flight event, and the walk falls back to the
    OTHER slot (the previous epoch, its own metadata supplying the
    epoch number) instead of surfacing a raw IO error deep in restore.
    The reference's elastic re-form path restores from it when the job
    shrinks or grows (``distributed/elastic.py``)."""
    try:
        with open(os.path.join(checkpoint_dir, _STATUS)) as f:
            s = json.load(f)
        slot_name, epoch = s["slot"], int(s["epoch"])
    except (OSError, ValueError, KeyError):
        return None
    candidates = [(os.path.join(checkpoint_dir, slot_name), epoch)]
    other = "slot1" if slot_name == "slot0" else "slot0"
    other_dir = os.path.join(checkpoint_dir, other)
    try:
        candidates.append((other_dir,
                           int(dckpt.checkpoint_meta(other_dir)["step"])))
    except (OSError, ValueError, KeyError, TypeError):
        pass                       # no usable second slot: one candidate
    for slot_dir, ep in candidates:
        if not verify:
            return slot_dir, ep
        problems = dckpt.verify_checkpoint(slot_dir)
        if not problems:
            return slot_dir, ep
        from paddle_tpu_torch.framework import monitor
        from paddle_tpu_torch.framework.observability import flight
        monitor.stat_add("ckpt_fallback_total")
        flight.record("ckpt.fallback", severity="warn", dir=slot_dir,
                      epoch=ep,
                      reasons=sorted({p["reason"] for p in problems}))
    return None


class TrainEpochRange:
    """Crash-resumable epoch iterator around a (Sharded)TrainStep.

    Usage::

        r = TrainEpochRange(max_epoch_num=10, name="job0",
                            train_step=step, checkpoint_dir=path)
        for epoch in r:
            ... train one epoch with `step` ...

    After a restart, epochs already checkpointed are skipped and the
    step's params/opt/buffers are restored before the first yielded epoch.
    """

    def __init__(self, max_epoch_num: int, name: str, train_step=None,
                 checkpoint_dir: Optional[str] = None,
                 save_checkpoint_inter: float = 0.0,
                 world_size: Optional[int] = None):
        self.max_epoch_num = max_epoch_num
        self.name = name
        self.train_step = train_step
        self.save_checkpoint_inter = save_checkpoint_inter
        self.world_size = world_size
        self.checkpoint_dir = checkpoint_dir or os.environ.get(
            "PADDLE_CHECKPOINT_DIR", os.path.join(".acp", name))
        self._last_save = 0.0
        self.restored_epoch = -1
        status = self._read_status()
        if status is not None and train_step is not None:
            # verified slot walk: a committed slot that rotted on disk
            # falls back to the other slot's epoch instead of crashing
            found = latest_checkpoint(self.checkpoint_dir)
            if found is not None:
                slot, epoch = found
                dckpt.load_train_state(train_step, slot)
                self.restored_epoch = int(epoch)

    # -- status record ------------------------------------------------------
    def _status_path(self):
        return os.path.join(self.checkpoint_dir, _STATUS)

    def _read_status(self):
        try:
            with open(self._status_path()) as f:
                s = json.load(f)
            return s if s.get("name") == self.name else None
        except (OSError, ValueError):
            return None

    def _write_status(self, epoch: int, slot: str):
        # atomic flip = commit point; routed through the chaos-instrumented
        # crash-safe writer so kill-mid-commit is injectable (fs.write)
        from paddle_tpu_torch.distributed.fleet.utils.fs import LocalFS
        LocalFS().atomic_write(
            self._status_path(),
            json.dumps({"name": self.name, "epoch": epoch, "slot": slot,
                        "time": time.time()}))

    # -- save ---------------------------------------------------------------
    def save_checkpoint(self, epoch: int):
        """Persist state for ``epoch`` into the inactive slot, then commit
        by atomically flipping the status record."""
        if self.train_step is None:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        status = self._read_status()
        slot = "slot1" if (status and status.get("slot") == "slot0") \
            else "slot0"
        slot_dir = os.path.join(self.checkpoint_dir, slot)
        if os.path.isdir(slot_dir):
            shutil.rmtree(slot_dir)
        dckpt.save_train_state(self.train_step, slot_dir, global_step=epoch,
                               world_size=self.world_size)
        # verify-before-flip: the status record must never point at a
        # slot that can't be read back — a failed verify leaves the old
        # status (and the old slot) standing
        problems = dckpt.verify_checkpoint(slot_dir)
        if problems:
            raise dckpt.CheckpointVerifyError(
                f"refusing to commit {slot_dir}: "
                + "; ".join(f"{p['file']}: {p['reason']}"
                            for p in problems[:4]))
        self._write_status(epoch, slot)
        self._last_save = time.monotonic()

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        start = self.restored_epoch + 1
        for epoch in range(start, self.max_epoch_num):
            yield epoch
            now = time.monotonic()
            if (self.save_checkpoint_inter <= 0 or
                    now - self._last_save >= self.save_checkpoint_inter or
                    epoch == self.max_epoch_num - 1):
                self.save_checkpoint(epoch)
        self._append_run_record(start)

    def _append_run_record(self, start_epoch: int):
        """A completed epoch range appends one ``train_epoch`` record to
        the run ledger when ``FLAGS_runlog_dir`` is set (reference
        ``:171-189``); the ledger never fails the loop it records."""
        try:
            from paddle_tpu_torch.framework import runlog
            path = runlog.default_ledger_path()
            if not path:
                return
            rec = runlog.capture(
                "train_epoch", label=self.name,
                extra={"epochs": {"start": start_epoch,
                                  "end": self.max_epoch_num - 1,
                                  "restored": self.restored_epoch}})
            runlog.RunLedger(path).append(rec)
        except Exception:          # noqa: BLE001 - the recorder never
            # crashes the loop
            pass


def train_epoch_range(max_epoch_num: int, name: str = "default",
                      train_step=None, checkpoint_dir: Optional[str] = None,
                      save_checkpoint_inter: float = 0.0):
    """Functional form matching ``acp.train_epoch_range(N, inter)``
    (auto_checkpoint.py:676)."""
    return iter(TrainEpochRange(max_epoch_num, name, train_step,
                                checkpoint_dir, save_checkpoint_inter))
