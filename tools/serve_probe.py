#!/usr/bin/env python3
"""Serving at full width alone: build the kernels (the handoff's Trainer
runs them), then ``chip_smoke.py``'s phase 11 and nothing else — the
train -> serve handoff, batch mode at prompt 1536 with a profiled decode
step, prefill against streamed decode, the Engine on the virtual and
the wall clock with a profiled tick, batching invariance and sampling
(``chip_smoke.phase11``'s docstring).  About a third of the whole
script's time.  With ``--mesh``: phase 18 instead, serving on a (data 2,
model 2) mesh of four ranks that share the card (``chip_smoke.phase18``'s
docstring; it runs no port kernel, so nothing is built).  Run from the
root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/serve_probe.py [--mesh]
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # as chip_smoke.main names it: cuBLAS's workspace on Hopper
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("serve_probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    chip_smoke.log(f"card: {smi.stdout.strip()}; torch {torch.__version__},"
                   f" CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    if "--mesh" in sys.argv[1:]:
        counts = chip_smoke.phase18(torch)
        chip_smoke.log(f"phase 18 done in {time.perf_counter() - t0:.1f} s; "
                       f"rank 0's launches {counts}")
        return
    from repro_torch.kernels import _build

    _build.build()
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    chip_smoke.phase11(torch)
    chip_smoke.log(f"phase 11 done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
