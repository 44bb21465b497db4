"""Fault-tolerance utilities (counterpart of ``repro/train/fault.py``).

Only ``discard_inflight`` so far: the watchdog, ``latest_restart_point``
and the kill/resume drill come with the distributed slice (ROADMAP.md
Queue 1 item 11).
"""
from __future__ import annotations

from repro_torch.optim import base


def discard_inflight(opt) -> None:
    """Mark any in-flight pending preconditioner stale after a restore
    (DESIGN.md §12).  Checkpoints drop the pending buffers
    (``checkpoint.save(drop=base.PENDING_STATE_KEYS)``), so a restored
    optimizer holds its own zeros there; clearing ``pending_at`` keeps
    the swap from ever consuming them, and the async service bootstraps
    anew at the first step after the restore.  No-op for optimizers
    without a refresh plane, so the Trainer calls it unconditionally."""
    base.discard_pending(opt)
