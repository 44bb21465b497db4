#!/usr/bin/env python3
"""The recurrent families at full width alone: build the kernels, check
and time K1/K2 at recurrentgemma-2b's and falcon-mamba-7b's Muon bucket
shapes (``chip_smoke.RECURRENT_SHAPES``, fp32), then ``chip_smoke.py``'s
phase 13 and nothing else — recurrentgemma-2b (26 layers) and
falcon-mamba-7b (8 layers) trained through ``launch/train.py``'s
configuration, served from their checkpoints, and decode against forward
in fp32 (``chip_smoke.phase13``'s docstring).  Run from the root of a
checkout, on a machine with a CUDA card and nvcc:

    python3 tools/recurrent_probe.py [--no-shapes]

``--no-shapes`` skips the K1/K2 shape checks and timings.
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
    # as chip_smoke.main names them: cuBLAS's workspace on Hopper and the
    # allocator's growable segments
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import chip_smoke

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", chip_smoke.ALLOC_CONF)
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("recurrent_probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    chip_smoke.log(f"card: {smi.stdout.strip()}; torch {torch.__version__},"
                   f" CUDA {torch.version.cuda}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f} s")
    if "--no-shapes" not in sys.argv[1:]:
        t0 = time.perf_counter()
        chip_smoke.gemm_shape_checks(torch, {}, chip_smoke.RECURRENT_SHAPES,
                                     ("float32",), 15)
        chip_smoke.gemm_shape_timings(torch, chip_smoke.RECURRENT_SHAPES,
                                      ("float32",), 16,
                                      chip_smoke.RECURRENT_REPS)
        torch.cuda.empty_cache()
        chip_smoke.log(f"K1/K2 at the recurrent families' shapes in "
                       f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = chip_smoke.phase13(torch)
    chip_smoke.log(f"phase 13 done in {time.perf_counter() - t0:.1f} s; "
                   f"launches of the training runs {counts}")
    chip_smoke.log(f"card: {smi.stdout.strip()}")


if __name__ == "__main__":
    main()
