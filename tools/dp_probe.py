#!/usr/bin/env python3
"""Data parallelism on the card alone: build the kernels, then
``chip_smoke.py``'s phase 14 and nothing else — two ranks that share the
card on gloo run the §8 engine, the Trainer, bf16 gradients and int8
compression, an elastic restore and the async plane at gpt2-paper's full
width (``chip_smoke.phase14``; the module docstring lists the gates).
Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/dp_probe.py
"""
from __future__ import annotations

import os
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
        chip_smoke.fail("dp_probe needs a CUDA device")
    card = chip_smoke._card_line()
    chip_smoke.log(f"card: {card}; torch {torch.__version__}, CUDA "
                   f"{torch.version.cuda}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = chip_smoke.phase14(torch)
    chip_smoke.log(f"phase 14 done in {time.perf_counter() - t0:.1f} s; "
                   f"rank 0's launches over (b) {counts}")
    chip_smoke.log(f"card: {card}")


if __name__ == "__main__":
    main()
