#!/usr/bin/env python3
"""The moe family at full width alone: build the kernels, check and time
K1/K2 at granite-moe's Muon bucket shapes (``chip_smoke.GRANITE_SHAPES``,
fp32), then ``chip_smoke.py``'s phase 12 and nothing else —
granite-moe-1b-a400m trained through ``launch/train.py`` and served from
its checkpoint, and mixtral, musicgen and llava at 2 layers
(``chip_smoke.phase12``'s docstring).  With ``--mesh``: K1/K2 at phase
16's shares of granite's buckets (``chip_smoke.P16_SHAPES``), then phase
16 and nothing else, granite on four ranks that share the card on a
(data 2, model 2) mesh (``chip_smoke.phase16``).  Run from the root of a
checkout, on a machine with a CUDA card and nvcc:

    python3 tools/moe_probe.py [--mesh]
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
    import chip_smoke

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", chip_smoke.ALLOC_CONF)
    mesh = "--mesh" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("moe_probe needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    chip_smoke.log(f"card: {smi.stdout.strip()}; torch {torch.__version__},"
                   f" CUDA {torch.version.cuda}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    shapes, seed = (chip_smoke.P16_SHAPES, 21) if mesh else \
        (chip_smoke.GRANITE_SHAPES, 13)
    chip_smoke.gemm_shape_checks(torch, {}, shapes, ("float32",), seed)
    chip_smoke.gemm_shape_timings(torch, shapes, ("float32",), seed + 1)
    torch.cuda.empty_cache()
    chip_smoke.log(f"K1/K2 at granite's shapes in "
                   f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = chip_smoke.phase16(torch) if mesh else chip_smoke.phase12(torch)
    chip_smoke.log(f"phase {16 if mesh else 12} done in "
                   f"{time.perf_counter() - t0:.1f} s; launches of the "
                   f"training runs {counts}")


if __name__ == "__main__":
    main()
