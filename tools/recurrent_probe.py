#!/usr/bin/env python3
"""The recurrent families at full width alone: build the kernels, check
and time K1/K2 at recurrentgemma-2b's and falcon-mamba-7b's Muon bucket
shapes (``chip_smoke.RECURRENT_SHAPES``, fp32), then ``chip_smoke.py``'s
phase 13 and nothing else — recurrentgemma-2b (26 layers) and
falcon-mamba-7b (8 layers) trained through ``launch/train.py``'s
configuration, served from their checkpoints, and decode against forward
in fp32 (``chip_smoke.phase13``'s docstring).  With ``--mesh``: K1/K2
at phase 17's shares (``chip_smoke.P17_SHAPES``), then phase 17 and
nothing else, falcon-mamba-7b, recurrentgemma-2b and musicgen-medium on
four ranks that share the card on a (data 2, model 2) mesh
(``chip_smoke.phase17``).  Run from the root of a checkout, on a machine
with a CUDA card and nvcc:

    python3 tools/recurrent_probe.py [--no-shapes] [--mesh]

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
    mesh = "--mesh" in sys.argv[1:]
    if "--no-shapes" not in sys.argv[1:]:
        t0 = time.perf_counter()
        shapes, seed = (chip_smoke.P17_SHAPES, 23) if mesh else \
            (chip_smoke.RECURRENT_SHAPES, 15)
        chip_smoke.gemm_shape_checks(torch, {}, shapes, ("float32",), seed)
        chip_smoke.gemm_shape_timings(torch, shapes, ("float32",), seed + 1,
                                      chip_smoke.RECURRENT_REPS)
        torch.cuda.empty_cache()
        chip_smoke.log(f"K1/K2 at the recurrent families' shapes in "
                       f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = chip_smoke.phase17(torch) if mesh else chip_smoke.phase13(torch)
    chip_smoke.log(f"phase {17 if mesh else 13} done in "
                   f"{time.perf_counter() - t0:.1f} s; launches of the "
                   f"training runs {counts}")
    chip_smoke.log(f"card: {smi.stdout.strip()}")


if __name__ == "__main__":
    main()
