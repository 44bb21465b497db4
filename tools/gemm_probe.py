#!/usr/bin/env python3
"""Time K1 ``matmul_add`` and K2 ``gram_upper`` of a source tree at the main
paths' shapes beside ``torch.baddbmm``, optionally with one deliberate
change to a kernel source, on a CUDA card.

The script copies ``<tree>/src`` into ``build/probe/<name>/`` (git-ignored),
applies the change there, builds that copy's kernels with ``-Xptxas -v``
(registers, shared memory and spills are printed) and times each kernel
with CUDA events (median of 20 launches, after 3 warm-up launches), with
``baddbmm`` timed on the same inputs in the same process; then it runs each
for half a second back to back and prints the median SM clock and board
power that ``nvidia-smi`` sampled meanwhile (kernel / ``baddbmm``).  Run from the
root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/gemm_probe.py [--tree DIR] [--dtype float32|bfloat16]
        [--change NAME]

``--tree`` defaults to this checkout; point it at an unpacked
``git archive`` of another commit to time that commit's kernels in the
same call.  ``--change`` names one entry of ``CHANGES``: the earlier
K2 kernel (one ``tile_gemm`` per block, the mirror written by a
column-strided store) without its store of the transposed off-diagonal
tile (the result is then wrong: this only times the store), or a setting
of the GEMM core to compare with the checkout's.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> [(file under src/repro_torch/kernels, text, replacement), ...];
# each text names one tree's code
CHANGES = {
    # the earlier K2 (tile_gemm, column-strided mirror) without that store
    "k2_without_mirror": [(
        "csrc/gram_upper.cu",
        "      if (bi != bj) R[(size_t)c * n + r] = o;\n", "")],
    # the core's ring with 3 or 6 slots instead of 4
    "stages3": [("csrc/gemm.cuh", "constexpr int STAGES = 4;",
                 "constexpr int STAGES = 3;")],
    "stages6": [("csrc/gemm.cuh", "constexpr int STAGES = 4;",
                 "constexpr int STAGES = 6;"),
                ("matmul_add.py", "STAGES = 4 ", "STAGES = 6 ")],
    # K1's block order: one row tile at a time (the raw order), or 32
    "group1": [("csrc/gemm.cuh", "constexpr int GROUP = 8;",
                "constexpr int GROUP = 1;")],
    "group32": [("csrc/gemm.cuh", "constexpr int GROUP = 8;",
                 "constexpr int GROUP = 32;")],
    # fp32 stage tiles without the XOR swizzle (K1's transposing stores
    # then conflict 4-way)
    "km32_plain": [("csrc/gemm.cuh",
                    "return k * TILE + (x ^ (((k >> 2) & 3) << 3));",
                    "return k * TILE + x;")],
    # one block an SM, up to 255 registers a thread
    "one_block_a_sm": [
        ("csrc/matmul_add.cu", "__launch_bounds__(THREADS, ALIGNED ? 2 : 1)",
         "__launch_bounds__(THREADS, 1)"),
        ("csrc/gram_upper.cu", "__launch_bounds__(THREADS, ALIGNED ? 2 : 1)",
         "__launch_bounds__(THREADS, 1)")],
}

PROBE = r"""
import statistics, subprocess, sys, time
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import _build, gram, matmul_add

dtype = getattr(torch, sys.argv[1])
_build.build(("matmul_add", "gram_upper"), verbose=True)


def ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def clocks(fn, seconds=0.5):
    # median SM clock (MHz) and board power (W) that nvidia-smi samples
    # while fn runs back to back for about `seconds`
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.count(",") == 1]
    if not rows:
        return float("nan"), float("nan")
    return (statistics.median(float(r[0]) for r in rows),
            statistics.median(float(r[1]) for r in rows))


gen = torch.Generator(device="cuda")
gen.manual_seed(1)
for shape in ((100, 1024, 1024), (40, 1024, 1024), (20, 4096, 1024)):
    B, m, n = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    r = torch.randn((B, n, n), generator=gen, device="cuda").to(dtype)
    k1 = ms(lambda: matmul_add.matmul_add(x, r, x, beta=0.5))
    lib1 = ms(lambda: torch.baddbmm(x, x, r, beta=0.5))
    mhz, watt = clocks(lambda: matmul_add.matmul_add(x, r, x, beta=0.5))
    lmhz, lwatt = clocks(lambda: torch.baddbmm(x, x, r, beta=0.5))
    print(f"probe matmul_add {shape} {sys.argv[1]} kernel {k1:.4f} ms "
          f"baddbmm {lib1:.4f} ms; sm clock {mhz:.0f} / {lmhz:.0f} MHz, "
          f"power {watt:.0f} / {lwatt:.0f} W", flush=True)
    k1n = ms(lambda: matmul_add.matmul_add(x, r))
    lib1n = ms(lambda: torch.bmm(x, r))
    print(f"probe matmul_add without C {shape} {sys.argv[1]} kernel "
          f"{k1n:.4f} ms bmm {lib1n:.4f} ms", flush=True)
    if B == 100:
        continue
    eye = torch.eye(n, device="cuda", dtype=dtype)
    xt = x.transpose(-1, -2)
    k2 = ms(lambda: gram.gram_upper(x))
    lib2 = ms(lambda: torch.baddbmm(eye, xt, x, alpha=-1.0))
    mhz, watt = clocks(lambda: gram.gram_upper(x))
    lmhz, lwatt = clocks(lambda: torch.baddbmm(eye, xt, x, alpha=-1.0))
    print(f"probe gram_upper {shape} {sys.argv[1]} kernel {k2:.4f} ms "
          f"baddbmm {lib2:.4f} ms; sm clock {mhz:.0f} / {lmhz:.0f} MHz, "
          f"power {watt:.0f} / {lwatt:.0f} W", flush=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--change", choices=sorted(CHANGES), default=None)
    args = ap.parse_args()
    name = f"{args.tree.resolve().name}-{args.change or 'as_is'}"
    d = ROOT / "build" / "probe" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(args.tree / "src", d / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, text, replacement in CHANGES.get(args.change, []):
        f = d / "src" / "repro_torch" / "kernels" / source
        code = f.read_text()
        if text not in code:
            raise SystemExit(f"{args.change}: the text to change is not in "
                             f"{source}")
        f.write_text(code.replace(text, replacement))
    print(f"probe tree {args.tree} change {args.change}", flush=True)
    r = subprocess.run([sys.executable, "-c", PROBE, args.dtype], cwd=d,
                       timeout=900)
    sys.exit(r.returncode)


if __name__ == "__main__":
    main()
