"""Fault-tolerance utilities (counterpart of ``repro/train/fault.py``).

On a real fleet a per-host supervisor watches the Trainer's HEARTBEAT
file (``"<step> <time>"``, rewritten every step by rank 0) and escalates:
log -> preempt the slow host -> restart from the newest checkpoint.
``Watchdog`` is the detection logic, runner-agnostic so that it is
testable on the CPU; ``latest_restart_point`` is the step a restart
resumes from.  The reference's kill/resume drill (``build_pipeline_trainer``
and its ``main``: a 1F1B pipeline run SIGKILLed and relaunched) comes
with the pipeline, ROADMAP.md Queue 1 item 11c.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.optim import base


@dataclass
class WatchdogConfig:
    stale_after_s: float = 300.0     # no heartbeat -> presume hang
    max_step_regression: int = 0     # heartbeat step must not go backwards


class Watchdog:
    def __init__(self, heartbeat_path: str,
                 cfg: Optional[WatchdogConfig] = None):
        self.path = heartbeat_path
        # never a shared default instance: one watchdog tweaking its
        # thresholds must not leak into the next
        self.cfg = WatchdogConfig() if cfg is None else cfg
        self.last_step: Optional[int] = None

    def read(self):
        """(step, wall_time) from the heartbeat file, or None."""
        try:
            with open(self.path) as f:
                step_s, t_s = f.read().split()
            return int(step_s), float(t_s)
        except (FileNotFoundError, ValueError):
            return None

    def check(self, now: Optional[float] = None) -> str:
        """'ok' | 'missing' | 'stale' | 'regressed'."""
        now = time.time() if now is None else now
        hb = self.read()
        if hb is None:
            return "missing"
        step, t = hb
        if now - t > self.cfg.stale_after_s:
            return "stale"
        if self.last_step is not None and \
                step < self.last_step - self.cfg.max_step_regression:
            return "regressed"
        self.last_step = step
        return "ok"

    def should_restart(self, now: Optional[float] = None) -> bool:
        return self.check(now) in ("stale", "regressed")


def discard_inflight(opt) -> None:
    """Mark any in-flight pending preconditioner stale after a restore
    (DESIGN.md §12).  Checkpoints drop the pending buffers
    (``checkpoint.save(drop=base.PENDING_STATE_KEYS)``), so a restored
    optimizer holds its own zeros there; clearing ``pending_at`` keeps
    the swap from ever consuming them, and the async service bootstraps
    anew at the first step after the restore.  No-op for optimizers
    without a refresh plane, so the Trainer calls it unconditionally."""
    base.discard_pending(opt)


def latest_restart_point(ckpt_dir: str) -> Optional[int]:
    """Step to restart from after a fault: the newest complete checkpoint
    (a crash mid-write leaves only a ``.tmp`` directory, never counted)."""
    from repro_torch.checkpoint import latest_step

    if not os.path.isdir(ckpt_dir):
        return None
    return latest_step(ckpt_dir)
