#!/usr/bin/env python3
"""Time the Trainer's async refresh plane (DESIGN.md §12) on a CUDA card,
with the step on the default stream and on a stream of higher priority
than the refresh's side stream, beside the synchronous cache.

gpt2-paper at full width, Muon PRISM-5 through the kernels, ``precond_every``
5, ``STEPS`` steps a run (refreshes at 0, 5, 10, 15), in three modes:

  * ``default``: ``Trainer.run`` as it is: the step on the default stream
    (the lowest priority), the refresh on the service's side stream (the
    same priority);
  * ``priority``: the same run inside ``torch.cuda.stream(s)`` with ``s``
    of the card's greatest priority, so that where both streams have a
    kernel waiting, the step's goes first;
  * ``sync``: ``precond_async=False``, the refresh inside the step.

The runs go default, priority, sync, sync, priority, default, and each
prints its dispatch steps (5, 10, 15), swap steps (6, 11) and the median of
its other steps (step 0, the run's first, left out), host clock to the
loss read; then one profiled dispatch step of each async mode (the
refresh's device time, the share of it under a step-stream kernel, the
card's idle share: ``chip_smoke.async_profile``).  Run from the root of a
checkout, on a machine with a CUDA card and nvcc:

    python3 tools/async_probe.py

Print only its ``^probe`` and ``profiled`` lines.
"""
from __future__ import annotations

import contextlib
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 16
K = 5
DISPATCH = (5, 10, 15)
SWAP = (6, 11)


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.launch import train_lm

    if not torch.cuda.is_available():
        sys.exit("async_probe: no CUDA device")
    _build.build()
    # a priority past the card's range maps to its greatest
    high = torch.cuda.Stream(priority=-100)
    profiled = set()
    work = Path(tempfile.mkdtemp(prefix="async_probe_",
                                 dir=ROOT / "build"))
    try:
        for mode in ("default", "priority", "sync", "sync", "priority",
                     "default"):
            cfgs = train_lm.configs("full", "prism", "float32",
                                    precond_every=K,
                                    precond_async=mode != "sync")
            tr = chip_smoke._trainer_for(cfgs, work / mode, 0, steps=STEPS,
                                         checkpoint_every=0)
            ctx = torch.cuda.stream(high) if mode == "priority" \
                else contextlib.nullcontext()
            with ctx:
                _, _, losses = tr.run()
                times = dict(zip(range(1, STEPS), tr.step_times))
                other = [v for t, v in times.items()
                         if t not in DISPATCH + SWAP]
                print(f"probe {mode}: dispatch "
                      + ", ".join(f"{times[t] * 1e3:.1f}" for t in DISPATCH)
                      + " ms; swap "
                      + ", ".join(f"{times[t] * 1e3:.1f}" for t in SWAP)
                      + f" ms; other steps median "
                      f"{statistics.median(other) * 1e3:.1f} ms ("
                      f"{min(other) * 1e3:.1f}-{max(other) * 1e3:.1f}); "
                      f"last loss {losses[-1]:.4f}", flush=True)
                if mode != "sync" and mode not in profiled:
                    profiled.add(mode)
                    print(f"probe {mode} profile:", flush=True)
                    chip_smoke.async_profile(torch, tr, STEPS - 1 + K)
            del tr
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
