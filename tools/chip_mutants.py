#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's bf16 comparisons of the fitted-
iteration kernels (K4 sketch_step, K5 sketch_chain, K6 residual_chain,
K7 apply_g) on a CUDA card.

For each mutant — one deliberate fault in one kernel source — the script
copies ``src/`` and ``chip_smoke.py`` into ``build/mutants/<name>/``
(git-ignored), applies the fault there, builds the kernels of that copy
and runs ``chip_smoke.fit_kernel_checks`` with bf16 as the only dtype.
The unbroken copy must pass; a mutant in ``EXPECT_FAIL`` must fail a
bf16 comparison; a mutant in ``EXPECT_PASS`` shows a fault that lies
below the bf16 tolerance.  Run from the root of a checkout, on a machine
with a CUDA card and nvcc:

    python3 tools/chip_mutants.py [--log-dir DIR]

Exits non-zero when any outcome differs from the expected one.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (source, text, replacement)
EXPECT_FAIL = {
    "k4_last_row_tile_idle": (
        "sketch_step.cu",
        "    if (nrows > 0)\n      prism::row_group_dot",
        "    if (nrows > 0 && tile != tiles - 1)\n      prism::row_group_dot"),
    "k5_every_power_reads_v0": (
        "sketch_chain.cu",
        "const T* vin = pw == 0 ? stt : ((pw & 1) ? v0 : v1);",
        "const T* vin = stt;"),
    "k6_residual_without_identity": (
        "residual_chain.cu",
        "__fsub_rn(i == j ? 1.f : 0.f, s)", "__fsub_rn(0.f, s)"),
    "k7_alpha_of_slice_0": (
        "apply_g.cu",
        "const float a = alpha[b];", "const float a = alpha[0];"),
}
EXPECT_PASS = {
    "k5_trace_from_rounded_v": (
        "sketch_chain.cu",
        "tpart = fmaf(N::to_f32(stt[o]), acc[j][c], tpart);",
        "tpart = fmaf(N::to_f32(stt[o]), N::to_f32(N::from_f32(acc[j][c])),"
        " tpart);"),
}

CHECK = ("import sys; sys.path.insert(0, 'src'); import torch; "
         "import chip_smoke as cs; cs.DTYPES = ('bfloat16',); "
         "from repro_torch.kernels import _build; _build.build(); "
         "cs.fit_kernel_checks(torch, {})")


def run_copy(name, mutation, log_dir):
    """Build and check one copy; returns (passed, first failing line)."""
    d = ROOT / "build" / "mutants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "src", d / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d)
    if mutation is not None:
        source, text, replacement = mutation
        f = d / "src" / "repro_torch" / "kernels" / "csrc" / source
        code = f.read_text()
        if text not in code:
            raise SystemExit(f"{name}: the text to break is not in {source}")
        f.write_text(code.replace(text, replacement))
    r = subprocess.run([sys.executable, "-c", CHECK], cwd=d,
                       capture_output=True, text=True, timeout=900)
    out = r.stdout + r.stderr
    if log_dir is not None:
        (log_dir / f"mutant_{name}.log").write_text(out)
    fails = [line.strip() for line in out.splitlines()
             if line.rstrip().endswith("FAIL")]
    return r.returncode == 0, fails[0] if fails else ""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", type=Path, default=None,
                    help="write each copy's output there")
    args = ap.parse_args()
    if args.log_dir is not None:
        args.log_dir.mkdir(parents=True, exist_ok=True)
    plan = [("unbroken", None, True)]
    plan += [(n, m, False) for n, m in EXPECT_FAIL.items()]
    plan += [(n, m, True) for n, m in EXPECT_PASS.items()]
    wrong = []
    for name, mutation, want_pass in plan:
        passed, first_fail = run_copy(name, mutation, args.log_dir)
        print(f"{name}: {'passed' if passed else 'failed'} "
              f"(expected to {'pass' if want_pass else 'fail'}) "
              f"{first_fail}", flush=True)
        if passed != want_pass:
            wrong.append(name)
    if wrong:
        raise SystemExit(f"unexpected outcome: {wrong}")


if __name__ == "__main__":
    main()
