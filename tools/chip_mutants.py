#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's comparisons on a CUDA card: the bf16
checks of the fitted-iteration kernels (K4 sketch_step, K6
residual_chain, K7 apply_g) and of the sign and coupled sqrt families of
K3, K6 and K7, the fp32 and bf16 checks of K5 sketch_chain (its thread-
block clusters: ``K5_EXPECT_FAIL``), and the fp32 and bf16 checks of K1
matmul_add and K2 gram_upper on their GEMM core (``csrc/gemm.cuh``).

For each mutant — one deliberate fault in the kernel sources — the script
copies ``src/`` and ``chip_smoke.py`` into ``build/mutants/<name>/``
(git-ignored), applies the fault there, builds the kernels of that copy
and runs its check: ``chip_smoke.fit_kernel_checks`` and
``chip_smoke.family_checks`` with bf16 as the only dtype; for the
mutants of K6's and K7's register-tiled designs
(``FUSED_EXPECT_FAIL``: K7's split grid, K6's trace reduction and
barrier), the same checks in fp32 first, then bf16; for the mutants in
``K5_EXPECT_FAIL``, ``chip_smoke.chain_checks`` (K5 alone, the only
kernel built) in fp32 and bf16, with two launches bitwise equal; for the
mutants in ``GEMM_EXPECT_FAIL``, ``chip_smoke.kernel_checks`` in fp32 and
bf16 (every K1/K2 shape, ragged ones included, with the NaN poison and
the symmetry check).
The unbroken copy must pass every check the chosen mutants run; a mutant
in ``EXPECT_FAIL``, ``FUSED_EXPECT_FAIL``, ``K5_EXPECT_FAIL`` or
``GEMM_EXPECT_FAIL`` must fail a comparison (or its run: a mutant may
also fault); a mutant in ``EXPECT_PASS`` shows a fault that lies below
the bf16 tolerance.  Run from the root of a checkout, on a machine with a
CUDA card and nvcc:

    python3 tools/chip_mutants.py [--log-dir DIR] [--only PREFIX ...]

``--only`` runs the unbroken copy and the mutants whose names start with
one of the prefixes (``--only k1_ k2_`` for the GEMM core's, ``--only
k5_`` for K5's, ``--only k6_ k7_`` for K6's and K7's).  Exits non-zero
when any outcome differs from the expected one.
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
    "k6_residual_without_identity": (
        "residual_chain.cu",
        "__fsub_rn(u == w ? 1.f : 0.f, s[a][b])", "__fsub_rn(0.f, s[a][b])"),
    "k7_alpha_of_slice_0": (
        "apply_g.cu",
        "const float a = alpha[b];", "const float a = alpha[0];"),
    # the families: each fault is invisible on symmetric or commuting
    # inputs, and must show on the independent, non-symmetric ones
    "k6_sign_computes_xtx": (
        "residual_chain.cu",
        "  if (FAMILY == POLAR) {\n    // R = I - X^T X",
        "  if (FAMILY != SQRT) {\n    // R = I - X^T X"),
    "k3_sqrt_reads_xy_for_yx": (
        "warm_tail.cu",
        "s = fmaf(N::to_f32(y[(size_t)i * n + k]),\n"
        "                   N::to_f32(x[(size_t)k * n + j]), s);",
        "s = fmaf(N::to_f32(x[(size_t)i * n + k]),\n"
        "                   N::to_f32(y[(size_t)k * n + j]), s);"),
    "k3_sqrt_without_symmetrization": (
        "warm_tail.cu",
        "__fmul_rn(0.5f, __fadd_rn(acc[(size_t)i * ld + j],\n"
        "                                      acc[(size_t)j * ld + i]));",
        "__fmul_rn(1.0f, __fadd_rn(acc[(size_t)i * ld + j], 0.f));"),
    "k7_y_horner_on_the_right": (
        "apply_g.cu",
        "horner<T, true>(src, ldw,", "horner<T, false>(src, ldw,"),
    # Y' computed from the block's columns of X instead of Y's
    "k7_y_staged_from_x": (
        "apply_g.cu",
        "stage<T, AG_THREADS>(src, ldw, Y + ",
        "stage<T, AG_THREADS>(src, ldw, X + "),
}

# the fused kernels' new designs (register tiles, K7's split grid, K6's
# trace reduction), checked in fp32 and bf16: name -> (source, text,
# replacement)
FUSED_EXPECT_FAIL = {
    # the last block of a slice's split skips its last row of X'
    "k7_last_split_skips_its_last_row": (
        "apply_g.cu", "const int h = min(H, m - r0);",
        "const int h = min(H, m - r0) - (s + 1 == splits);"),
    # ... or its last column of Y'
    "k7_last_split_skips_its_last_y_column": (
        "apply_g.cu", "const int w = min(H, n - r0);",
        "const int w = min(H, n - r0) - (s + 1 == splits);"),
    # thread 0 leaves the first warp's trace partial out of its sum
    "k6_trace_drops_a_warp_partial": (
        "residual_chain.cu",
        "for (int w = 0; w < RC_WARPS; ++w) sum",
        "for (int w = 1; w < RC_WARPS; ++w) sum"),
    # no barrier after a power: the next power (and thread 0's sum of the
    # partials) reads before the others wrote
    "k6_chain_reads_before_the_barrier": (
        "residual_chain.cu",
        "    __syncthreads();  // V' and this power's partials are written\n",
        ""),
}
EXPECT_PASS = {
    # the trace of the rounded V_i: below the bf16 tolerance (and nothing
    # in fp32), so the §9 order is not what these checks can see
    "k5_trace_from_rounded_v": (
        "sketch_chain.cu",
        "tsum = fmaf(N::to_f32(sto[row * p + c]), s, tsum);",
        "tsum = fmaf(N::to_f32(sto[row * p + c]), N::to_f32(N::from_f32(s)),"
        " tsum);"),
}

# K5 alone (``chip_smoke.chain_checks``, fp32 and bf16): name -> (source,
# text, replacement)
K5_EXPECT_FAIL = {
    "k5_every_power_reads_v0": (
        "sketch_chain.cu", "const T* vin = (pw & 1) ? v1 : v0;",
        "const T* vin = v0;"),
    # no cluster barrier between powers (the last one stays, so that no
    # block leaves while others store into it): a rank reads V_i before
    # its peers wrote it, and rank 0 sums partials not yet stored
    "k5_no_cluster_barrier_between_powers": (
        "sketch_chain.cu",
        "    cluster.sync();\n    if (rank == 0 && tid == 0) {",
        "    if (push) __syncthreads(); else cluster.sync();\n"
        "    if (rank == 0 && tid == 0) {"),
    # rank 0 leaves the last rank's trace partial out of its sum
    "k5_last_rank_partial_left_out": (
        "sketch_chain.cu", "for (int src = 0; src < CLUSTER; ++src)",
        "for (int src = 0; src < CLUSTER - 1; ++src)"),
    # the rank that holds the ragged edge of R skips its last row
    "k5_ragged_rank_skips_its_last_row": (
        "sketch_chain.cu", "const int rows = min(q, n - r0);",
        "const int rows = min(q, n - r0) - (n - r0 < q && n > r0);"),
}

# K1/K2 on the GEMM core: name -> [(source, text, replacement), ...]
GEMM_EXPECT_FAIL = {
    # the mainloop computes on the slot of stage kt + 1, still in flight
    "k1_k2_ring_reads_the_stage_being_filled": [(
        "gemm.cuh", "const int cur = kt % STAGES;",
        "const int cur = (kt + 1) % STAGES;")],
    # the tile edges are no longer zero-filled: the 16-byte copies of the
    # aligned variant copy the clamped source instead of zeros ((1, 1000,
    # 300) fp32), and the scalar loads of the unaligned one read past the
    # contraction's end ((1, 55, 55))
    "k1_k2_ragged_edge_without_zero_fill": [
        ("gemm.cuh", '"l"(src), "r"(pred ? 16 : 0));', '"l"(src), "r"(16));'),
        ("gemm.cuh",
         "if (k0 + k < K && c0 + x < cols) v = g[(size_t)(k0 + k) * ld + "
         "c0 + x];",
         "if (c0 + x < cols) v = g[(size_t)(k0 + k) * ld + c0 + x];"),
        ("gemm.cuh",
         "if (row0 + m < M && k0 + k < K) v = a[(size_t)(row0 + m) * K + "
         "k0 + k];",
         "if (row0 + m < M) v = a[(size_t)(row0 + m) * K + k0 + k];")],
    # an off-diagonal Gram tile no longer writes its transpose
    "k2_off_diagonal_tile_without_its_transpose": [(
        "gram_upper.cu",
        "    if (bi == bj) return;\n    // its transpose",
        "    return;\n    // its transpose")],
    # the last group of row tiles is never computed
    "k1_grouped_order_skips_its_last_group": [(
        "matmul_add.cu", "  const int bi = first + w % rows;",
        "  if (first + rows == mt && first > 0) return;\n"
        "  const int bi = first + w % rows;")],
}

CHECK = ("import sys; sys.path.insert(0, 'src'); import torch; "
         "import chip_smoke as cs; cs.DTYPES = ('bfloat16',); "
         "from repro_torch.kernels import _build; _build.build(); "
         "cs.fit_kernel_checks(torch, {}); cs.family_checks(torch, {})")
FUSED_CHECK = CHECK.replace("('bfloat16',)", "('float32', 'bfloat16')")
GEMM_CHECK = ("import sys; sys.path.insert(0, 'src'); import torch; "
              "import chip_smoke as cs; "
              "from repro_torch.kernels import _build; _build.build(); "
              "cs.kernel_checks(torch)")
# builds K5 only
K5_CHECK = ("import sys; sys.path.insert(0, 'src'); import torch; "
            "import chip_smoke as cs; "
            "from repro_torch.kernels import _build; "
            "_build.KERNELS = ('sketch_chain',); "
            "_build.build(('sketch_chain',)); cs.chain_checks(torch)")


def run_copy(name, edits, checks, log_dir):
    """Build and check one copy with ``edits`` applied; returns (passed,
    first failing line)."""
    d = ROOT / "build" / "mutants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "src", d / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d)
    for source, text, replacement in edits:
        f = d / "src" / "repro_torch" / "kernels" / "csrc" / source
        code = f.read_text()
        if text not in code:
            raise SystemExit(f"{name}: the text to break is not in {source}")
        f.write_text(code.replace(text, replacement))
    out, code = "", 0
    for check in checks:
        r = subprocess.run([sys.executable, "-c", check], cwd=d,
                           capture_output=True, text=True, timeout=900)
        out += r.stdout + r.stderr
        code = code or r.returncode
    if log_dir is not None:
        (log_dir / f"mutant_{name}.log").write_text(out)
    fails = [line.strip() for line in out.splitlines()
             if "FAIL" in line or "Error" in line]
    return code == 0, fails[0] if fails else ""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", type=Path, default=None,
                    help="write each copy's output there")
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only the mutants with these name prefixes")
    args = ap.parse_args()
    if args.log_dir is not None:
        args.log_dir.mkdir(parents=True, exist_ok=True)
    plan = [(n, [m], (CHECK,), False) for n, m in EXPECT_FAIL.items()]
    plan += [(n, [m], (FUSED_CHECK,), False)
             for n, m in FUSED_EXPECT_FAIL.items()]
    plan += [(n, [m], (K5_CHECK,), False)
             for n, m in K5_EXPECT_FAIL.items()]
    plan += [(n, m, (GEMM_CHECK,), False)
             for n, m in GEMM_EXPECT_FAIL.items()]
    plan += [(n, [m], (K5_CHECK,), True) for n, m in EXPECT_PASS.items()]
    if args.only is not None:
        plan = [p for p in plan if p[0].startswith(tuple(args.only))]
    # the unbroken copy passes every check the chosen mutants run
    # (FUSED_CHECK covers CHECK: the same checks in both dtypes)
    used = {c for p in plan for c in p[2]}
    checks = tuple(c for c in (FUSED_CHECK, K5_CHECK, GEMM_CHECK)
                   if c in used or (c == FUSED_CHECK and CHECK in used))
    plan.insert(0, ("unbroken", [], checks, True))
    wrong = []
    for name, edits, checks, want_pass in plan:
        passed, first_fail = run_copy(name, edits, checks, args.log_dir)
        print(f"{name}: {'passed' if passed else 'failed'} "
              f"(expected to {'pass' if want_pass else 'fail'}) "
              f"{first_fail}", flush=True)
        if passed != want_pass:
            wrong.append(name)
    if wrong:
        raise SystemExit(f"unexpected outcome: {wrong}")


if __name__ == "__main__":
    main()
