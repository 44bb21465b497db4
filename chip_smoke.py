#!/usr/bin/env python3
"""Proof on one NVIDIA H100 that the PyTorch port builds, is right and trains.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

  1. the card: CUDA present, its name and power limit (nvidia-smi);
  2. build every kernel from src/repro_torch/kernels/csrc (one nvcc per
     source, all at once) and print the compiler's register/spill report,
     with a summary of each K1/K2 instantiation (a spill fails);
  3. each kernel against its plain PyTorch version on the card, in fp32 and
     bf16, at the shapes the main paths give it and at ragged ones, with the
     reference's tolerances on results of unit scale (see ``check``); the
     sign and coupled sqrt families of K3, K6 and K7 also on non-symmetric,
     independent X and Y, at the Shampoo bias shapes and at the largest
     coupled slice the fused tier admits in each dtype (one just above it
     must take the grid tier); K5 (one thread-block cluster a slice) at
     every main-path shape, at n below its cluster size and at p = 1 and
     16, with two launches bitwise equal, and two K6 launches bitwise
     equal in every family; every main-path K1/K2 shape must take the
     kernels' aligned instantiation; at every main-path shape, in fp32 (K1
     and K2 also in bf16), the kernel, the plain version and one PyTorch
     library call (where one computes the same function) are timed with
     CUDA events (median of 20 launches; K3, K6 and K7, shorter than the
     host's time to launch them, also as the median of 20 runs of 10
     launches back to back and as the mean device time of 20 launches in
     a profiler trace);
  4. the PRISM-5 path: the gpt2-paper Muon/PRISM-5 training step at full
     width (seq 512, batch 4, random weights from seed 0), STEPS steps
     through ``repro_torch.launch.train_lm.build``; the launch counts are
     zeroed just before and read just after (no K1/K2 launch may take
     the unaligned instantiation on any path), and must be 19 a step
     (matmul_add 12, gram_upper 6, warm_tail 1); the losses must be finite
     and start near ln(50257); one Muon update through the kernels must
     agree with the same update through the plain versions
     (``use_kernels=False``); the Muon step and the forward+backward pass
     are timed on their own;
  5. the PRISM-3 path: the same step with PRISM-3 (degree 1, 3 warm then 2
     fitted iterations), which runs the fitted-iteration kernels: 29
     launches a step (matmul_add 10, gram_upper 10, warm_tail 1,
     sketch_chain 4, residual_chain 2, apply_g 2), the same loss and update
     gates; the fallback path: one PRISM-3 Muon step with the shared-memory
     budget forced below sketch_chain's footprint, so that the chain runs
     as sketch_step launches (24), within the same bound of the step
     through sketch_chain; the synchronizing calls of one Muon step of each
     configuration (the fit must add none); a profiler trace of one PRISM-3
     Muon step; an adaptive run (``tol``) on a grid-tier and a fused-tier
     bucket whose launches must match the iterations it ran;
  6. the Shampoo PRISM-5 path: the gpt2-paper step with Shampoo and its
     default PRISM (degree 2, 3 warm iterations), ``precondition_every=1``
     so that every step computes the inverse roots: 17 launches a step
     (matmul_add 15 on the [100, 1024, 1024] factor bucket, warm_tail 2 on
     the bias buckets [30, 16, 16] and [30, 64, 64], sqrt family), the
     same loss and update gates, a profiler trace of one Shampoo step;
  7. the Shampoo fitted path (benchmarks/fig5_shampoo.py's PrismConfig:
     degree 2, 5 fitted iterations, sketch 8; lr 3e-3): 50 launches a step
     (matmul_add 25, sketch_chain 5, residual_chain 10, apply_g 10), the
     same loss gates, the update gate with the kernel run's fitted alphas
     (``PINNED_ALPHA``); with ``precondition_every=2`` the second step
     launches nothing; the synchronizing calls of one Muon and one
     Shampoo step (no more than the one K3's alpha copy made before it
     became a kernel argument; the fit adds none); a profiler trace of
     one step; adaptive ``matfn.sqrtm`` runs whose launches must match
     their iterations; the Shampoo step with ``matfn_method="eigh"``
     timed beside it;
  8. the ``kernels`` JSON line, and last the ``ok`` JSON line.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
STEPS = 4                 # full-width training steps; the first warms up
TIMED_REPS = 20           # launches per CUDA-event median
BACK_TO_BACK = 10         # launches a run of the back-to-back timing
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
WARM_TOL = {"float32": 2e-4, "bfloat16": 5e-2}     # tests/test_fused_iter.py
# K4/K5 traces (tests/test_kernels.py) and K6/K7 (tests/test_fused_iter.py)
FIT_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
DTYPES = ("float32", "bfloat16")  # dtypes of the phase 3 checks
KERNEL_NAMES = ("matmul_add", "gram_upper", "warm_tail", "sketch_step",
                "sketch_chain", "residual_chain", "apply_g")
# launches a training step, per path (optimizer and PRISM configuration)
PER_STEP = {
    "prism5": dict(matmul_add=12, gram_upper=6, warm_tail=1),
    "prism3": dict(matmul_add=10, gram_upper=10, warm_tail=1,
                   sketch_chain=4, residual_chain=2, apply_g=2),
    "shampoo_prism5": dict(matmul_add=15, warm_tail=2),
    "shampoo_fig5": dict(matmul_add=25, sketch_chain=5, residual_chain=10,
                         apply_g=10),
}
# Paths whose update gate replays the kernel run's fitted alphas into the
# run through torch.matmul.  Shampoo's factors are rank-deficient (a bias
# gradient [16, 64] gives R = G^T G of rank 16 a step) and their fitted
# alpha, the argmin of a nearly flat sketched objective, moves with the
# last bits of the traces, so the kernels' summation order alone moves
# the fitted Shampoo update by about 1e-3 of its largest entry.  The gate
# holds the update with the kernel run's alphas; the unpinned gap and the
# alpha gap are printed beside it (PERF.md).
PINNED_ALPHA = {"shampoo_fig5"}
# (optimizer, PRISM configuration of launch/train_lm.py) of each path
PATHS = {"prism5": ("muon", "prism5"), "prism3": ("muon", "prism3"),
         "shampoo_prism5": ("shampoo", "prism5"),
         "shampoo_fig5": ("shampoo", "fig5")}
# synchronizing calls of one Muon step while K3 copied its alpha vector
# from the host (PERF.md); no optimizer step may make more
SYNCS_BOUND = 1

# Muon update through the kernels vs through torch.matmul (fp32 matfn): the
# two differ only in fp32 summation order, which three quintic iterations
# amplify by at most ~30x; 1e-3 of the largest update entry is far above
# that and far below any real fault (a wrong tile or epilogue moves whole
# entries).
UPDATE_REL_TOL = 1e-3
# H100 SXM peaks (NVIDIA's data sheet: dense rates, 700 W)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- timing

def time_ms(torch, fn, reps: int = TIMED_REPS, warmup: int = 3,
            batch: int = 1) -> float:
    """Median time of one call of ``fn`` over ``reps`` runs of ``batch``
    calls back to back between two CUDA events: with ``batch`` 1 the host's
    launch time is inside; with more, the device's time of a kernel that
    runs longer than the host takes to launch it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, reps: int = TIMED_REPS):
    """Mean device time of one launch of ``kernel`` (the CUDA kernels whose
    name holds ``<kernel>_kernel``) over ``reps`` calls of ``fn``, from a
    torch.profiler trace: the card's time, whatever the host's.  None when
    the trace holds none of its launches (the profiler drops a trace now
    and then); it is a measurement, not a gate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and f"{kernel}_kernel" in e.key:
            total += e.self_device_time_total
            count += e.count
    if not count:
        log(f"  {kernel}: the profile holds none of its {reps} launches")
        return None
    return total / 1e3 / count


def small_times(torch, fn, kernel: str) -> dict:
    """A fused-tier kernel (K3, K6, K7) runs for less than the host takes
    to launch it, so a single launch between two events times the host:
    its back-to-back time (``BACK_TO_BACK`` launches between two events,
    still host-bound below ~30 us) and its profiled device time."""
    return dict(b2b_ms=time_ms(torch, fn, batch=BACK_TO_BACK),
                device_ms=device_ms(torch, fn, kernel))


def small_note(t: dict) -> str:
    if "b2b_ms" not in t:
        return ""
    dev = t["device_ms"]
    dev = "not measured" if dev is None else f"{dev:.4f} ms"
    return f" (back to back {t['b2b_ms']:.4f} ms, device {dev})"


def bound_ms(flops: float, nbytes: float, dtype: str):
    """(least time in ms, what bounds it): the larger of flops over the
    card's peak for the operand type and bytes over its memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


# --------------------------------------------------------------- inputs

def randn(torch, shape, gen, scale=1.0):
    return scale * torch.randn(shape, generator=gen, device="cuda")


def normalized(torch, shape, gen):
    """X / ||X||_F per slice: what newton_schulz.polar feeds the chain."""
    x = randn(torch, shape, gen)
    return x / torch.linalg.matrix_norm(x, keepdim=True)


def poison(torch, shape, dtype, count: int = 1) -> None:
    """Free ``count`` NaN-filled blocks of this size just before a kernel
    call: the caching allocator hands them to the kernel's outputs, so an
    output the kernel fails to write reads as NaN instead of stale,
    plausible data."""
    ts = [torch.full(tuple(shape), float("nan"), dtype=dtype, device="cuda")
          for _ in range(count)]
    del ts


def same_twice(torch, name, shape, dtype, first, again) -> None:
    """A second launch on the same inputs gives bitwise the same outputs:
    every sum of the kernel runs in a fixed order."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail(f"{name} {shape} {dtype}: two launches are not bitwise equal")


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(torch, name, shape, dtype, got, want, tol) -> float:
    """|got - want| <= tol + tol * |want| entrywise: the reference tests'
    atol = rtol = tol, which they apply to results of unit scale.  Where a
    slice's largest |want| is below 1 (K3's orthonormalized output, entries
    ~0.1), the absolute term shrinks with it, so that a small result is
    not passed by the absolute term alone."""
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        fail(f"{name} {shape} {dtype}: got {tuple(got.shape)} {got.dtype}, "
             f"want {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{name} {shape} {dtype}: non-finite output")
    err = max_err(torch, got, want)
    want32 = want.float().abs()
    scale = want32.amax(dim=(-2, -1), keepdim=True).clamp(max=1.0)
    ok = bool(torch.all((got.float() - want.float()).abs()
                        <= tol * scale + tol * want32))
    log(f"  {name:10s} {str(shape):22s} {dtype:8s} max_abs_err {err:.3e} "
        f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {shape} {dtype} disagrees with its plain version")
    return err


# --------------------------------------------------------------- phase 3

def unaligned_launches() -> int:
    """Launches of K1's and K2's element-by-element instantiation so far."""
    from repro_torch.kernels import gram, matmul_add

    return matmul_add.unaligned_launches + gram.unaligned_launches


def kernel_checks(torch):
    from repro_torch.kernels import fused_iter, gram, matmul_add, ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    coeffs = ops._gd_coeffs(2)
    rows = {}

    # O(1) operands, scaled so that the entries of each result are of unit
    # size or more: A, B ~ N(0, 1/sqrt(k)) make A @ B ~ N(0, 1), beside
    # C ~ N(0, 1); X ~ N(0, 1/sqrt(m)) makes the off-diagonal of X^T X
    # ~ N(0, 1) and its diagonal ~sqrt(m).  The Gram runs with the main
    # path's alpha = 1, beta = -1, and again with alpha = sqrt(m) / 2 and
    # beta = 1/2, where alpha I is as large as the diagonal it lands on and
    # the sign of beta shows.  B is not symmetric, so a transposed operand
    # shows.
    gemm_shapes = [(40, 1024, 1024), (20, 4096, 1024),      # main paths
                   (100, 1024, 1024),
                   (1, 55, 55), (2, 96, 64), (1, 1000, 300)]
    for shape in gemm_shapes:
        B, m, n = shape
        a32 = randn(torch, shape, gen, n ** -0.25)
        b32 = randn(torch, (B, n, n), gen, n ** -0.25)
        c32 = randn(torch, shape, gen)
        x32 = randn(torch, shape, gen, m ** -0.25)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            a, b, c, x = (t.to(dt) for t in (a32, b32, c32, x32))
            fast = matmul_add.aligned(a, b, c) and matmul_add.aligned(x)
            before = unaligned_launches()
            want = matmul_add.plain(a, b, c, alpha=1.0, beta=0.5)
            poison(torch, shape, dt)
            got = matmul_add.matmul_add(a, b, c, alpha=1.0, beta=0.5)
            err_mm = check(torch, "matmul_add", shape, dtype, got, want,
                           KERNEL_TOL[dtype])
            want = matmul_add.plain(a, b, alpha=-0.75)
            poison(torch, shape, dt)
            got = matmul_add.matmul_add(a, b, alpha=-0.75)
            check(torch, "matmul_add", shape, dtype, got, want,
                  KERNEL_TOL[dtype])
            for alpha, beta in ((1.0, -1.0), (0.5 * m ** 0.5, 0.5)):
                poison(torch, (B, n, n), dt)
                got = gram.gram_upper(x, alpha=alpha, beta=beta)
                want = gram.plain(x, alpha=alpha, beta=beta)
                err = check(torch, "gram_upper", shape, dtype, got, want,
                            KERNEL_TOL[dtype])
                if not torch.equal(got, got.transpose(-1, -2)):
                    fail(f"gram_upper {shape} {dtype}: result not "
                         f"symmetric")
                if beta == -1.0:
                    err_g = err
            took = unaligned_launches() - before
            log(f"  matmul_add/gram_upper {shape} {dtype}: "
                f"{'aligned' if fast else 'unaligned'} instantiation "
                f"({took} of 4 launches unaligned)")
            if took != (0 if fast else 4):
                fail(f"{shape} {dtype}: {took} unaligned launches, "
                     f"predicate says {'aligned' if fast else 'unaligned'}")
            if B in (20, 40, 100):
                if not fast:
                    fail(f"main-path shape {shape} {dtype} takes K1/K2's "
                         f"unaligned instantiation")
                key = (shape,) if dtype == "float32" else (shape, dtype)
                rows[("matmul_add",) + key] = dict(
                    shape=[list(shape), [B, n, n]], max_abs_err=err_mm)
                rows[("gram_upper",) + key] = dict(shape=[list(shape)],
                                                   max_abs_err=err_g)

    # K3 on the bias bucket (3 warm iterations of alpha = u = 1.45)
    for shape in [(30, 64, 16), (5, 55, 23)]:
        x32 = normalized(torch, shape, gen)
        for dtype in DTYPES:
            x = x32.to(getattr(torch, dtype))
            alphas = (1.45, 1.45, 1.45)
            want = fused_iter.plain(x, alphas, coeffs=coeffs)
            poison(torch, shape, x.dtype)
            got = fused_iter.warm_tail(x, alphas, coeffs=coeffs)
            err = check(torch, "warm_tail", shape, dtype, got, want,
                        WARM_TOL[dtype])
            want = fused_iter.plain(x, alphas[:1], coeffs=coeffs)
            poison(torch, shape, x.dtype)
            got = fused_iter.warm_tail(x, alphas[:1], coeffs=coeffs)
            check(torch, "warm_tail", shape, dtype, got, want,
                  WARM_TOL[dtype])
            if shape == (30, 64, 16) and dtype == "float32":
                rows["warm_tail"] = dict(shape=[list(shape)],
                                         operands=(x,), max_abs_err=err)
                rows[("warm_tail", shape)] = rows["warm_tail"]
    return rows


def spectrum_r(torch, B, n, gen, radius=0.95):
    """Symmetric [B, n, n] with eigenvalues +-radius in random directions
    (Q diag(+-radius) Q^T): every power keeps unit size, and consecutive
    powers differ (odd ones change sign), so the traces of a chain that
    mixes up its powers or buffers come out wrong by O(1)."""
    q, _ = torch.linalg.qr(randn(torch, (B, n, n), gen))
    d = radius * torch.sign(randn(torch, (B, 1, n), gen))
    return (q * d) @ q.transpose(-1, -2)


# K5's checks: the grid-tier residual buckets of the main paths (fp32 and
# bf16) and ragged cases (n below the cluster size, n not a multiple of
# the vector width, p = 1 and p = 16): (shape, p, chain lengths)
CHAIN_CASES = [((40, 1024, 1024), 8, (6, 10)),
               ((20, 1024, 1024), 8, (6,)),
               ((100, 1024, 1024), 8, (6, 10)),
               ((3, 300, 300), 5, (6, 10)),
               ((2, 37, 37), 12, (6, 10)),
               ((1, 5, 5), 1, (1,)),
               ((1, 1024, 1024), 16, (6, 10))]


def chain_case(torch, r, st, powers, rows):
    """K5 against its plain version on R [B, n, n] and St [n, p] for each
    chain length in ``powers`` (traces checked per slice as [B, 1, powers]
    so that ``check`` scales per slice); at [40, 1024, 1024] x 6 two
    launches must agree bit for bit."""
    from repro_torch.kernels import sketch_traces

    B, n, _ = r.shape
    p = st.shape[1]
    dtype = str(r.dtype).replace("torch.", "")
    for maxp in powers:
        want = sketch_traces.plain_chain(r, st, maxp)
        poison(torch, (B, maxp), torch.float32)
        got = sketch_traces.sketch_chain(r, st, maxp)
        err = check(torch, "sketch_chain", (B, n, p, maxp), dtype,
                    got.reshape(B, 1, maxp), want.reshape(B, 1, maxp),
                    FIT_TOL[dtype])
        if (B, maxp) == (40, 6):
            # every trace has a fixed order of summation
            poison(torch, (B, maxp), torch.float32)
            again = sketch_traces.sketch_chain(r, st, maxp)
            torch.cuda.synchronize()
            if not torch.equal(again, got):
                fail(f"sketch_chain {tuple(r.shape)} {dtype}: two launches "
                     f"differ (worst {max_err(torch, again, got):.3e})")
            log(f"  sketch_chain {tuple(r.shape)} {dtype}: two launches "
                f"bitwise equal")
            if dtype == "float32":
                rows["sketch_chain"] = dict(
                    shape=[[B, n, n], [n, p], maxp], max_abs_err=err,
                    operands=(r, st))
        if B in (20, 40, 100) and dtype == "float32":
            rows[("sketch_chain", (B, n, n, maxp))] = dict(
                shape=[[B, n, n], [n, p], maxp], max_abs_err=err)


def chain_checks(torch):
    """K5 alone on every case of ``CHAIN_CASES``, in each of ``DTYPES``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = {}
    for shape, p, powers in CHAIN_CASES:
        B, n, _ = shape
        r32 = spectrum_r(torch, B, n, gen)
        s32 = randn(torch, (p, n), gen, p ** -0.5)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            chain_case(torch, r32.to(dt), s32.t().contiguous().to(dt),
                       powers, rows)
    return rows


def fit_kernel_checks(torch, rows):
    """K4-K7 against their plain versions, fp32 and bf16, at the PRISM-3
    main-path shapes and at ragged ones (K5 by ``chain_case`` on
    ``CHAIN_CASES``).  Traces are checked per slice as [B, 1, powers] so
    that ``check`` scales per slice."""
    from repro_torch.kernels import fused_iter, ops, sketch_traces

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    # K5 / K4 on the grid-tier residual buckets and at ragged ones
    for shape, p, powers in CHAIN_CASES:
        B, n, _ = shape
        r32 = spectrum_r(torch, B, n, gen)
        s32 = randn(torch, (p, n), gen, p ** -0.5)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            r, st = r32.to(dt), s32.t().contiguous().to(dt)
            chain_case(torch, r, st, powers, rows)
            # K4: two powers, the second from the first's V'
            v = st.expand(B, n, p).contiguous()
            for pw in range(2):
                want_v, want_t = sketch_traces.plain_step(r, v, st)
                poison(torch, (B, n, p), dt)
                got_v, got_t = sketch_traces.sketch_step(r, v, st)
                err_v = check(torch, "sketch_step", (B, n, p), dtype, got_v,
                              want_v, FIT_TOL[dtype])
                err_t = check(torch, "sketch_step", (B, n, p), dtype,
                              got_t.reshape(B, 1, 1),
                              want_t.reshape(B, 1, 1), FIT_TOL[dtype])
                v = want_v
            if shape[0] == 40 and dtype == "float32":
                rows["sketch_step"] = dict(
                    shape=[list(shape), [B, n, p]],
                    max_abs_err=max(err_v, err_t), operands=(r, st))
                rows[("sketch_step", shape)] = rows["sketch_step"]
            # ops.sketch_traces with the budget forced down runs K4's loop
            t_k5 = ops.sketch_traces(r, s32.to(dt), 6)
            t_k4 = ops.sketch_traces(r, s32.to(dt), 6, budget=1024)
            check(torch, "sketch_step", (B, n, p, "chain"), dtype,
                  t_k4.reshape(B, 1, 7), t_k5.reshape(B, 1, 7),
                  FIT_TOL[dtype])

    # K6 / K7 on the fused-tier bias bucket.  K6: X ~ N(0, 0.9/m), so that
    # X^T X spreads over ~[0.2, 2] and R = I - X^T X over ~[-1, 0.8]
    # (unit-size powers).  K7: X ~ N(0, 1) and R with eigenvalues +-0.95,
    # so that X g(R) is of unit size, and a different alpha in every slice.
    for shape, p in [((30, 64, 16), 8), ((5, 55, 23), 5)]:
        B, m, n = shape
        x_rc = randn(torch, shape, gen, (0.9 / m) ** 0.5)
        s32 = randn(torch, (p, n), gen, p ** -0.5)
        x_ag = randn(torch, shape, gen)
        r_ag = spectrum_r(torch, B, n, gen)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            x, S = x_rc.to(dt), s32.to(dt)
            st = S.t().contiguous()
            for maxp in (6, 10):
                want_r, want_t = fused_iter.plain_residual_chain(x, S, maxp)
                poison(torch, (B, n, n), dt)
                got_r, got_t = fused_iter.residual_chain(x, st, maxp)
                err_r = check(torch, "residual_chain", shape, dtype, got_r,
                              want_r, FIT_TOL[dtype])
                err_t = check(torch, "residual_chain", (B, m, n, maxp),
                              dtype, got_t.reshape(B, 1, maxp),
                              want_t.reshape(B, 1, maxp), FIT_TOL[dtype])
                same_twice(torch, "residual_chain", (B, m, n, maxp), dtype,
                           (got_r, got_t),
                           fused_iter.residual_chain(x, st, maxp))
                if shape == (30, 64, 16) and dtype == "float32" and \
                        maxp == 6:
                    rows["residual_chain"] = dict(
                        shape=[list(shape), [n, p], maxp],
                        max_abs_err=max(err_r, err_t), operands=(x, st))
                    rows[("residual_chain", shape + (maxp,))] = \
                        rows["residual_chain"]
            xa, ra = x_ag.to(dt), r_ag.to(dt)
            for degree in (1, 2):
                coeffs = ops._gd_coeffs(degree)
                lo, hi = {1: (0.5, 1.0), 2: (0.375, 1.45)}[degree]
                alpha = torch.linspace(lo, hi, B, device="cuda")
                want = fused_iter.plain_apply_g(xa, ra, alpha, coeffs=coeffs)
                poison(torch, shape, dt)
                got = fused_iter.apply_g(xa, ra, alpha, coeffs=coeffs)
                err = check(torch, "apply_g", (B, m, n, f"d{degree}"),
                            dtype, got, want, FIT_TOL[dtype])
                if shape == (30, 64, 16) and dtype == "float32" and \
                        degree == 1:
                    rows["apply_g"] = dict(shape=[list(shape), [B, n, n]],
                                           max_abs_err=err,
                                           operands=(xa, ra, alpha))
                    rows[("apply_g", shape)] = rows["apply_g"]
    return rows


def coupled_limit(dtype: str) -> int:
    """The largest n whose coupled [n, n] slice the fused tier admits."""
    from repro_torch.kernels import ops

    n = 8
    while ops.fused_fits((n + 1, n + 1), dtype, coupled=True):
        n += 1
    return n


def nonsym(torch, shape, gen):
    """Non-symmetric [B, n, n] with entries N(0, 0.5 / sqrt(n)): spectral
    radius ~0.5, so I - X X, sym(I - Y X) and their powers stay of unit
    size, while X X differs from X^T X and Y X from X Y by O(1)."""
    return randn(torch, shape, gen, 0.5 * shape[-1] ** -0.5)


def spd(torch, B, n, gen, lo=0.05):
    """Symmetric positive definite [B, n, n], ||.||_F = 1, eigenvalues
    spread over [lo, 1] before the scaling: what Shampoo's sqrtm feeds the
    chain (X = A, Y = I)."""
    q, _ = torch.linalg.qr(randn(torch, (B, n, n), gen))
    lam = lo + (1 - lo) * torch.rand((B, 1, n), generator=gen, device="cuda")
    a = (q * lam) @ q.transpose(-1, -2)
    return a / torch.linalg.matrix_norm(a, keepdim=True)


def family_checks(torch, rows):
    """The sign and coupled sqrt families of K3, K6 and K7 against their
    plain versions, fp32 and bf16, at the Shampoo bias shapes [30, 16, 16]
    and [30, 64, 64] and at the largest coupled slice the fused tier admits
    in each dtype.  Each kernel runs on non-symmetric, independent X and Y
    (for which X^T X != X X and Y X != X Y: symmetric or commuting inputs
    would pass a kernel with those mixed up); K3 runs one iteration there,
    where the function stays of unit size, and three on Shampoo's own
    inputs (X = A symmetric positive definite, Y = I; sign on a symmetric
    X).  K7 runs with a non-symmetric R (0.95 times an orthogonal matrix)
    and a different alpha in every slice.  A coupled slice one larger than
    the limit must take the grid tier."""
    from repro_torch.config import PrismConfig
    from repro_torch.core import newton_schulz
    from repro_torch.core.rng import Key
    from repro_torch.kernels import fused_iter, ops
    from repro_torch.core import matfn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    coeffs = ops._gd_coeffs(2)
    warm = (1.45, 1.45, 1.45)
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        big = coupled_limit(dtype)
        for shape in [(30, 16, 16), (30, 64, 64), (4, big, big)]:
            B, n, _ = shape
            main = B == 30 and dtype == "float32"
            x, y = (nonsym(torch, shape, gen).to(dt) for _ in range(2))
            a_spd = spd(torch, B, n, gen).to(dt)
            eye = torch.eye(n, device="cuda", dtype=dt).expand(shape)
            x_sym = (normalized(torch, shape, gen) +
                     normalized(torch, shape, gen).transpose(-1, -2)) / 2
            x_sym = x_sym.to(dt)
            # K3: one iteration on independent inputs, three on Shampoo's
            for what, fam, xx, yy, al in (
                    ("nonsym", "sign", x, None, warm[:1]),
                    ("nonsym", "sqrt", x, y, warm[:1]),
                    ("sym", "sign", x_sym, None, warm),
                    ("spd,I", "sqrt", a_spd, eye.contiguous(), warm)):
                want = fused_iter.plain(xx, al, coeffs=coeffs, family=fam,
                                        Y=yy)
                poison(torch, shape, dt)
                got = fused_iter.warm_tail(xx, al, coeffs=coeffs,
                                           family=fam, Y=yy)
                if fam == "sqrt":
                    err = max(check(torch, f"warm_tail/{fam}",
                                    (B, n, n, what, len(al)), dtype, g, w,
                                    WARM_TOL[dtype])
                              for g, w in zip(got, want))
                else:
                    err = check(torch, f"warm_tail/{fam}",
                                (B, n, n, what, len(al)), dtype, got, want,
                                WARM_TOL[dtype])
                if main and what in ("sym", "spd,I"):
                    rows[(f"warm_tail/{fam}", shape)] = dict(
                        shape=[list(shape), len(al)], max_abs_err=err)
            # K6 on the independent inputs, 6 and 10 powers
            S = randn(torch, (8, n), gen, 8 ** -0.5).to(dt)
            st = S.t().contiguous()
            for fam, yy in (("sign", None), ("sqrt", y)):
                for maxp in (6, 10):
                    want_r, want_t = fused_iter.plain_residual_chain(
                        x, S, maxp, family=fam, Y=yy)
                    poison(torch, (B, n, n), dt)
                    got_r, got_t = fused_iter.residual_chain(
                        x, st, maxp, family=fam, Y=yy)
                    name = f"residual_chain/{fam}"
                    err_r = check(torch, name, shape, dtype, got_r, want_r,
                                  FIT_TOL[dtype])
                    err_t = check(torch, name, (B, n, n, maxp), dtype,
                                  got_t.reshape(B, 1, maxp),
                                  want_t.reshape(B, 1, maxp), FIT_TOL[dtype])
                    if fam == "sqrt" and not torch.equal(
                            got_r, got_r.transpose(-1, -2)):
                        fail(f"{name} {shape} {dtype}: R not symmetric")
                    same_twice(torch, name, (B, n, n, maxp), dtype,
                               (got_r, got_t), fused_iter.residual_chain(
                                   x, st, maxp, family=fam, Y=yy))
                    if main and maxp == 10:
                        rows[(name, shape)] = dict(
                            shape=[list(shape), [n, 8], maxp],
                            max_abs_err=max(err_r, err_t))
            # K7 coupled: X, Y ~ N(0, 1), R = 0.95 Q (not symmetric)
            q, _ = torch.linalg.qr(randn(torch, shape, gen))
            r = (0.95 * q).to(dt).contiguous()
            xa, ya = randn(torch, shape, gen).to(dt), \
                randn(torch, shape, gen).to(dt)
            for degree in (1, 2):
                cf = ops._gd_coeffs(degree)
                lo, hi = {1: (0.5, 1.0), 2: (0.375, 1.45)}[degree]
                alpha = torch.linspace(lo, hi, B, device="cuda")
                want = fused_iter.plain_apply_g(xa, r, alpha, coeffs=cf,
                                                Y=ya)
                poison(torch, shape, dt, count=2)
                got = fused_iter.apply_g(xa, r, alpha, coeffs=cf, Y=ya)
                err = max(check(torch, "apply_g/coupled",
                                (B, n, n, f"d{degree}", side), dtype, g, w,
                                FIT_TOL[dtype])
                          for g, w, side in zip(got, want, ("X'", "Y'")))
                if main and degree == 2:
                    rows[("apply_g/coupled", shape)] = dict(
                        shape=[list(shape), [B, n, n]], max_abs_err=err)
        # one past the limit: the grid tier, never a fused launch
        over = big + 1
        cfg = PrismConfig(degree=2, iterations=2, warm_alpha_iters=1,
                          sketch_dim=8, dtype=dtype, use_kernels=True)
        if newton_schulz._fused_tier(cfg, (over, over), coupled=True) or \
                not newton_schulz._fused_tier(cfg, (big, big), coupled=True):
            fail(f"coupled fused-tier limit in {dtype} is not {big}")
        try:
            fused_iter.warm_tail(eye_like(torch, over, dt), (1.0,),
                                 coeffs=coeffs, family="sqrt",
                                 Y=eye_like(torch, over, dt))
        except ValueError:
            pass
        else:
            fail(f"warm_tail took a coupled [{over}, {over}] {dtype} slice")
        ops.reset_launches()
        matfn.sqrtm(spd(torch, 2, over, gen).to(dt), cfg=cfg, key=Key(1))
        counts = ops.launch_counts()
        if counts["warm_tail"] or counts["residual_chain"] or \
                counts["apply_g"] or not counts["matmul_add"]:
            fail(f"sqrtm on [2, {over}, {over}] {dtype}: launches {counts}")
        log(f"  coupled fused-tier limit {dtype}: [{big}, {big}] "
            f"({ops.fused_smem_bytes((big, big), dtype, coupled=True)} "
            f"bytes); [{over}, {over}] needs "
            f"{ops.fused_smem_bytes((over, over), dtype, coupled=True)} and "
            f"took the grid tier: {counts}")
    return rows


def eye_like(torch, n, dt):
    return torch.eye(n, device="cuda", dtype=dt).expand(1, n, n).contiguous()


def fit_kernel_timings(torch, rows):
    """ms / plain_ms / bound_ms of one launch of K4-K7 (polar) at their
    main-path shapes, fp32 (K5 at all three: the Shampoo factor bucket
    [100, 1024, 1024] with 10 powers, and PRISM-3's [40, 1024, 1024] and
    [20, 1024, 1024] with 6), with K5's cluster size, resident clusters,
    registers, spills and achieved rate; keyed by (name, shape).  No single
    PyTorch call computes any of them (a chain of products with a trace
    epilogue; a residual with its chain; a Horner chain with a per-slice
    alpha), so ``library_ms`` is null."""
    from repro_torch.kernels import fused_iter, ops, sketch_traces

    item = 4
    out = {}
    r, st = rows["sketch_chain"]["operands"]
    B, n, _ = r.shape
    p = st.shape[1]
    maxp = 6
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for nb, powers in ((100, 10), (40, 6), (20, 6)):
        rb = r if nb == B else spectrum_r(torch, nb, n, gen)
        t = out[("sketch_chain", (nb, n, n, powers))] = dict(
            ms=time_ms(torch, lambda: sketch_traces.sketch_chain(
                rb, st, powers)),
            plain_ms=time_ms(torch, lambda: sketch_traces.plain_chain(
                rb, st, powers)),
            library_ms=None,
            # 2 n^2 p flops a power; R read once, St read, traces written
            bound=bound_ms(2.0 * nb * powers * n * n * p,
                           item * (nb * n * n + n * p + nb * powers),
                           "float32"))
        info = sketch_traces.chain_launch_info(rb, st)
        streamed = item * nb * powers * n * n   # R once a power
        log(f"  sketch_chain ({nb}, {n}, {n}) x {powers}: cluster "
            f"{info['cluster']}, {info['active_clusters']} clusters "
            f"resident ({info['active_clusters'] * item * n * n / 1e6:.1f} "
            f"MB of R in their slices), {info['registers']} registers, "
            f"{info['local_bytes']} B local (spills), {info['threads']} "
            f"threads, {info['stages']} stages, {info['rows_a_warp']} rows "
            f"a warp, {info['smem_bytes']} B shared; R streamed "
            f"{streamed / 1e9:.3f} GB at {streamed / t['ms'] / 1e6:.1f} GB/s "
            f"(device-memory floor {streamed / PEAK_BYTES * 1e3:.4f} ms)")
        del rb
    v = st.expand(B, n, p).contiguous()
    out[("sketch_step", (B, n, n))] = dict(
        ms=time_ms(torch, lambda: sketch_traces.sketch_step(r, v, st)),
        plain_ms=time_ms(torch, lambda: sketch_traces.plain_step(r, v, st)),
        library_ms=None,
        bound=bound_ms(2.0 * B * n * n * p,
                       item * (B * n * n + 2 * B * n * p + n * p + B),
                       "float32"))
    x, st6 = rows["residual_chain"]["operands"]
    S6 = st6.t().contiguous()
    B, m, n = x.shape
    p = st6.shape[1]
    out[("residual_chain", (B, m, n, maxp))] = dict(
        ms=time_ms(torch, lambda: fused_iter.residual_chain(x, st6, maxp)),
        **small_times(torch, lambda: fused_iter.residual_chain(x, st6, maxp),
                      "residual_chain"),
        plain_ms=time_ms(torch, lambda: fused_iter.plain_residual_chain(
            x, S6, maxp)),
        library_ms=None,
        # the Gram (full, 2 m n^2) and the chain; X and St read, R and t
        # written
        bound=bound_ms(B * (2.0 * m * n * n + 2.0 * maxp * n * n * p),
                       item * (B * m * n + n * p + B * n * n + B * maxp),
                       "float32"))
    xa, ra, alpha = rows["apply_g"]["operands"]
    coeffs = ops._gd_coeffs(1)
    out[("apply_g", (B, m, n))] = dict(
        ms=time_ms(torch, lambda: fused_iter.apply_g(xa, ra, alpha,
                                                     coeffs=coeffs)),
        **small_times(torch, lambda: fused_iter.apply_g(
            xa, ra, alpha, coeffs=coeffs), "apply_g"),
        plain_ms=time_ms(torch, lambda: fused_iter.plain_apply_g(
            xa, ra, alpha, coeffs=coeffs)),
        library_ms=None,
        bound=bound_ms(B * (2.0 * m * n * n + 3.0 * m * n),
                       item * (2 * B * m * n + B * n * n + B), "float32"))
    for (name, shape), t in out.items():
        log(f"  {name:14s} {str(shape):22s} float32 kernel "
            f"{t['ms']:.4f} ms{small_note(t)}  plain {t['plain_ms']:.4f} "
            f"ms  library none  bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]})")
    return out


def family_timings(torch):
    """ms / plain_ms / bound_ms of one launch of the sign and coupled sqrt
    families of K3, K6 and K7 at the Shampoo bias shapes, fp32, on the
    inputs the main path gives them (X = A symmetric positive definite,
    Y = I; 3 warm iterations of degree 2; 10 powers with p = 8).  No
    single PyTorch call computes any of them: ``library_ms`` is null.
    Keys: (name, shape)."""
    from repro_torch.kernels import fused_iter, ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    item, d, maxp, p = 4, 2, 10, 8
    coeffs = ops._gd_coeffs(d)
    warm = (1.45,) * 3
    out = {}
    for shape in [(30, 16, 16), (30, 64, 64)]:
        B, n, _ = shape
        a = spd(torch, B, n, gen)
        eye = torch.eye(n, device="cuda").expand(shape).contiguous()
        S = randn(torch, (p, n), gen, p ** -0.5)
        st = S.t().contiguous()
        alpha = torch.full((B,), 1.2, device="cuda")
        r = ops.residual_chain(a, S, maxp, family="sqrt", Y=eye)[0]
        mat = B * n * n
        horner = d * 2.0 * n ** 3 + (3 * d + 1) * n * n   # one side
        cases = {
            # residual 2 n^3 (+ sym), then one Horner a side, per iteration
            "warm_tail/sqrt": (
                lambda: fused_iter.warm_tail(a, warm, coeffs=coeffs,
                                             family="sqrt", Y=eye),
                lambda: fused_iter.plain(a, warm, coeffs=coeffs,
                                         family="sqrt", Y=eye),
                len(warm) * B * (2.0 * n ** 3 + 3 * n * n + 2 * horner),
                item * 4 * mat),
            "warm_tail/sign": (
                lambda: fused_iter.warm_tail(a, warm, coeffs=coeffs,
                                             family="sign"),
                lambda: fused_iter.plain(a, warm, coeffs=coeffs,
                                         family="sign"),
                len(warm) * B * (2.0 * n ** 3 + n * n + horner),
                item * 2 * mat),
            # residual, then the chain's 2 n^2 p a power; X (Y), St read,
            # R and the traces written
            "residual_chain/sqrt": (
                lambda: fused_iter.residual_chain(a, st, maxp, family="sqrt",
                                                  Y=eye),
                lambda: fused_iter.plain_residual_chain(
                    a, S, maxp, family="sqrt", Y=eye),
                B * (2.0 * n ** 3 + 3 * n * n + 2.0 * maxp * n * n * p),
                item * (3 * mat + n * p + B * maxp)),
            "residual_chain/sign": (
                lambda: fused_iter.residual_chain(a, st, maxp,
                                                  family="sign"),
                lambda: fused_iter.plain_residual_chain(a, S, maxp,
                                                        family="sign"),
                B * (2.0 * n ** 3 + n * n + 2.0 * maxp * n * n * p),
                item * (2 * mat + n * p + B * maxp)),
            # one Horner a side; X, Y, R read, X', Y' written, alpha read
            "apply_g/coupled": (
                lambda: fused_iter.apply_g(a, r, alpha, coeffs=coeffs,
                                           Y=eye),
                lambda: fused_iter.plain_apply_g(a, r, alpha, coeffs=coeffs,
                                                 Y=eye),
                B * 2 * horner, item * (5 * mat + B)),
        }
        for name, (kern, plain, flops, nbytes) in cases.items():
            t = dict(ms=time_ms(torch, kern),
                     **small_times(torch, kern, name.split("/")[0]),
                     plain_ms=time_ms(torch, plain), library_ms=None,
                     bound=bound_ms(flops, nbytes, "float32"))
            out[(name, shape)] = t
            log(f"  {name:20s} {str(shape):14s} float32 kernel "
                f"{t['ms']:.4f} ms{small_note(t)}  plain "
                f"{t['plain_ms']:.4f} ms  library none  bound "
                f"{t['bound'][0]:.6f} ms ({t['bound'][1]})")
    return out


def kernel_timings(torch, rows):
    """ms / plain_ms / library_ms / bound_ms of one launch of each kernel at
    each main-path shape, fp32 (the main paths' matfn dtype), keyed by
    (name, shape); K1 and K2 also in bf16 (tensor cores, bf16 bound),
    keyed by (name, shape, "bfloat16")."""
    from repro_torch.kernels import fused_iter, gram, matmul_add, ops

    coeffs = ops._gd_coeffs(2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    main_shapes = [("matmul_add", (40, 1024, 1024), "float32"),
                   ("matmul_add", (20, 4096, 1024), "float32"),
                   ("matmul_add", (100, 1024, 1024), "float32"),
                   ("gram_upper", (40, 1024, 1024), "float32"),
                   ("gram_upper", (20, 4096, 1024), "float32"),
                   ("warm_tail", (30, 64, 16), "float32")]
    main_shapes += [(name, shape, "bfloat16")
                    for name, shape, _ in main_shapes[:5]]
    out = {}
    for name, shape, dtype in main_shapes:
        B, m, n = shape
        dt = getattr(torch, dtype)
        item = 2 if dtype == "bfloat16" else 4
        if name == "warm_tail":
            x = rows["warm_tail"]["operands"][0]
            alphas, d = (1.45,) * 3, 2
            flops = len(alphas) * B * (m * n * (n + 1) + d * 2.0 * m * n * n
                                       + (3 * d + 1) * m * n)
            t = dict(
                ms=time_ms(torch, lambda: fused_iter.warm_tail(
                    x, alphas, coeffs=coeffs)),
                **small_times(torch, lambda: fused_iter.warm_tail(
                    x, alphas, coeffs=coeffs), "warm_tail"),
                plain_ms=time_ms(torch, lambda: fused_iter.plain(
                    x, alphas, coeffs=coeffs)),
                library_ms=None,
                bound=bound_ms(flops, item * 2 * B * m * n + 4 * len(alphas),
                               "float32"))
        else:
            x = normalized(torch, shape, gen).to(dt)
            if name == "matmul_add":
                r = gram.plain(x)
                acc = 1.45 * x
                t = dict(
                    ms=time_ms(torch, lambda: matmul_add.matmul_add(
                        acc, r, x, beta=0.5)),
                    plain_ms=time_ms(torch, lambda: matmul_add.plain(
                        acc, r, x, beta=0.5)),
                    library_ms=time_ms(torch, lambda: torch.baddbmm(
                        x, acc, r, beta=0.5)),
                    # A, C, D [B, m, n] and R [B, n, n], each moved once
                    bound=bound_ms(2.0 * B * m * n * n + 3.0 * B * m * n,
                                   item * (3 * B * m * n + B * n * n),
                                   dtype))
            else:
                eye = torch.eye(n, device="cuda", dtype=dt)
                xt = x.transpose(-1, -2)
                t = dict(
                    ms=time_ms(torch, lambda: gram.gram_upper(x)),
                    plain_ms=time_ms(torch, lambda: gram.plain(x)),
                    library_ms=time_ms(torch, lambda: torch.baddbmm(
                        eye, xt, x, alpha=-1.0)),
                    bound=bound_ms(1.0 * B * m * n * (n + 1),
                                   item * (B * m * n + B * n * n),
                                   dtype))
            del x
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"  {name:10s} {str(shape):18s} {dtype:8s} kernel "
            f"{t['ms']:.4f} ms{small_note(t)}  plain {t['plain_ms']:.4f} "
            f"ms  library {lib} ms  bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]})")
        out[(name, shape) if dtype == "float32"
            else (name, shape, dtype)] = t
    return out


# --------------------------------------------------------------- phases 4-5

def _clone_state(opt):
    return ({p: {k: v.clone() for k, v in st.items()}
             for p, st in opt.state.items()}, opt.count)


def _opt_from(torch, model, cfg, state):
    """The optimizer ``cfg.name`` names, with a copy of ``state``."""
    from repro_torch.optim import make_optimizer

    opt = make_optimizer(cfg, model.named_parameters(), model.logical_axes())
    per_param, count = state
    for p, st in per_param.items():
        opt.state[p] = {k: v.clone() for k, v in st.items()}
    opt.count = count
    return opt


def _with_prism(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, prism=dataclasses.replace(cfg.prism,
                                                              **kw))


def _expect_launches(counts, want, what):
    full = dict.fromkeys(KERNEL_NAMES, 0)
    full.update(want)
    if counts != full:
        fail(f"{what}: launches {counts}, want {full}")


def _restore(torch, model, run):
    """Parameters and gradients as the last training step left them."""
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(run["before"][k])
            p.grad = run["grads"][k].clone()


def _opt_step(torch, model, cfg, run, key):
    """One optimizer update from the saved state, parameters and gradients;
    returns (milliseconds, parameter deltas)."""
    o = _opt_from(torch, model, cfg, run["state"])
    _restore(torch, model, run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o.step(key=key)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, {k: (p.detach() - run["before"][k])
                for k, p in model.named_parameters()}


def _worst_gap(torch, got, want, what, gate=True):
    worst = 0.0
    for k, dk in got.items():
        dp = want[k]
        scale = float(dp.abs().max())
        rel = float((dk - dp).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if gate and not rel <= UPDATE_REL_TOL:
            fail(f"{what}: the update of {k} differs by {rel:.3e} of the "
                 f"largest update entry (bound {UPDATE_REL_TOL})")
    return worst


class AlphaTape:
    """Records the fitted alphas of a run in call order (``replay=None``),
    or hands a recorded run's alphas back in the same order: every fit
    goes through ``prism.fit_alpha_from_traces`` (the fused tier's K6
    traces and the grid tier's sketched chain alike), which is patched
    for the duration of a ``with`` block."""

    def __init__(self, replay=None):
        self.alphas = []
        self.replay = replay

    def __enter__(self):
        from repro_torch.core import prism

        self._real = real = prism.fit_alpha_from_traces

        def fit(*a, **k):
            out = real(*a, **k)
            if self.replay is not None:
                alpha = self.replay[len(self.alphas)]
                out = (alpha, out[1]) if isinstance(out, tuple) else alpha
            self.alphas.append(out[0] if isinstance(out, tuple) else out)
            return out

        prism.fit_alpha_from_traces = fit
        return self

    def __exit__(self, *exc):
        from repro_torch.core import prism

        prism.fit_alpha_from_traces = self._real


def count_syncs(torch, fn):
    """The synchronizing CUDA calls ``fn()`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def train_path(torch, path):
    """The gpt2-paper training step at full width on ``path`` (a key of
    PATHS: the optimizer and its PRISM configuration): STEPS steps through
    the launcher's ``build``, the launch, loss and update gates, and the
    timings."""
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops
    from repro_torch.launch import train_lm

    optimizer, prism = PATHS[path]
    unaligned = unaligned_launches()
    model, opt, step, batch_fn, (seq, batch) = train_lm.build(
        "full", "prism", "float32", device="cuda", seed=0, prism=prism,
        optimizer=optimizer, precondition_every=1)
    pc = opt.cfg.prism
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model {model.cfg.name}: {n_params} params, seq {seq}, batch "
        f"{batch}, {optimizer} {prism} (degree {pc.degree}, "
        f"{pc.warm_alpha_iters} warm of {pc.iterations} iterations, sketch "
        f"{pc.sketch_dim}, lr {opt.cfg.learning_rate}), use_kernels=True, "
        f"matfn_dtype float32")
    batches = [batch_fn(s) for s in range(STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        m = step(b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = ops.launch_counts()
    if unaligned_launches() != unaligned:
        fail(f"{path}: K1/K2 launched their unaligned instantiation "
             f"({unaligned} -> {unaligned_launches()} launches)")

    peak_mem = torch.cuda.max_memory_allocated()
    for i, (loss, t) in enumerate(zip(losses, times)):
        log(f"  step {i}: loss {loss:.4f}  {t:.1f} ms")
    step_ms = statistics.median(times[1:])
    log(f"  step time (median of steps 1..{STEPS - 1}): {step_ms:.1f} ms, "
        f"{seq * batch / (step_ms / 1e3):.0f} tokens/s, "
        f"max_memory_allocated {peak_mem / 2**30:.2f} GiB")
    log(f"  launches over {STEPS} steps: {counts}")
    per_step = PER_STEP[path]
    _expect_launches(counts, {k: v * STEPS for k, v in per_step.items()},
                     f"{path} ({sum(per_step.values())} a step: "
                     f"{per_step})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss: {losses}")
    ln_v = math.log(model.cfg.vocab_size)
    if abs(losses[0] - ln_v) > 1.5:
        fail(f"first loss {losses[0]:.4f} not within 1.5 of ln(V) "
             f"{ln_v:.4f}")

    # one update through the kernels vs through the plain versions, on the
    # clipped gradients the last step left in .grad, with the key the next
    # step would use
    run = dict(model=model, opt=opt, key=Key(0).fold_in(STEPS),
               before={k: p.detach().clone()
                       for k, p in model.named_parameters()},
               grads={k: p.grad.clone()
                      for k, p in model.named_parameters()},
               state=_clone_state(opt), counts=counts, step_ms=step_ms,
               peak_gib=peak_mem / 2**30)
    deltas, opt_ms, tapes = {}, {"kernels": [], "plain": []}, {}
    for tag in ("kernels", "plain", "plain", "kernels"):
        cfg = _with_prism(opt.cfg, use_kernels=tag == "kernels")
        with AlphaTape() as tape:
            ms, d = _opt_step(torch, model, cfg, run, run["key"])
        opt_ms[tag].append(ms)
        deltas.setdefault(tag, d)
        tapes.setdefault(tag, tape.alphas)
    pinned = path in PINNED_ALPHA
    worst = _worst_gap(torch, deltas["kernels"], deltas["plain"],
                       f"{path} kernels vs plain", gate=not pinned)
    if pinned:
        # the same update through torch.matmul with the kernel run's
        # fitted alphas: what the kernels compute, apart from the fit
        dalpha = max((float((a - b).abs().max()) for a, b in
                      zip(tapes["kernels"], tapes["plain"])), default=0.0)
        with AlphaTape(replay=tapes["kernels"]) as tape:
            _, d = _opt_step(torch, model,
                             _with_prism(opt.cfg, use_kernels=False), run,
                             run["key"])
        if len(tape.alphas) != len(tapes["kernels"]):
            fail(f"{path}: {len(tape.alphas)} fits through torch.matmul, "
                 f"{len(tapes['kernels'])} through the kernels")
        worst_pinned = _worst_gap(torch, deltas["kernels"], d,
                                  f"{path} kernels vs plain, same alphas")
        log(f"  {len(tape.alphas)} alpha fits a step; largest alpha gap "
            f"kernels vs plain {dalpha:.3e}; update gap with the kernel "
            f"run's alphas {worst_pinned:.3e} (bound {UPDATE_REL_TOL})")
        run.update(dalpha=dalpha, worst_pinned=worst_pinned)
    run.update(deltas=deltas, opt_ms=opt_ms, worst=worst)
    # forward + backward alone (the rest of a step is clipping and the
    # optimizer)
    fb = []
    for b in batches[1:]:
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.loss(b)[0].backward()
        torch.cuda.synchronize()
        fb.append((time.perf_counter() - t0) * 1e3)
    log(f"  forward+backward alone (median of {len(fb)}): "
        f"{statistics.median(fb):.1f} ms")
    gate = ("printed; the gate holds the same alphas" if pinned
            else f"bound {UPDATE_REL_TOL}")
    log(f"  {optimizer} update, kernels vs plain versions: worst relative "
        f"gap {worst:.3e} ({gate})")
    log(f"  {optimizer} step through the kernels "
        + ", ".join(f"{t:.1f}" for t in opt_ms["kernels"])
        + " ms; through torch.matmul (use_kernels=False) "
        + ", ".join(f"{t:.1f}" for t in opt_ms["plain"]) + " ms")
    # the synchronizing calls of one optimizer step through the kernels
    o = _opt_from(torch, model, opt.cfg, run["state"])
    _restore(torch, model, run)
    run["syncs"] = count_syncs(torch, lambda: o.step(key=run["key"]))
    log(f"  synchronizing calls in one {optimizer} step: "
        f"{len(run['syncs'])} {sorted(set(run['syncs']))}")
    if len(run["syncs"]) > SYNCS_BOUND:
        fail(f"{path}: {len(run['syncs'])} synchronizing calls in one "
             f"{optimizer} step, more than the {SYNCS_BOUND} of K3's former "
             f"alpha copy")
    return run


def fallback_path(torch, run):
    """One PRISM-3 Muon step with the shared-memory budget forced just
    below sketch_chain's footprint on the grid buckets' Gram side (96 KiB
    at d_model = 1024, fp32, p = 8; the fused tier's bias view needs 17 KB
    and keeps its tier): the chains run as sketch_step launches (2 buckets
    x 2 fits x 6 powers), and the update stays within UPDATE_REL_TOL of
    the update through sketch_chain."""
    from repro_torch.kernels import ops, sketch_traces

    pc = run["opt"].cfg.prism
    budget = sketch_traces.chain_smem_bytes(
        run["model"].cfg.d_model, pc.sketch_dim, 4) - 16
    cfg = _with_prism(run["opt"].cfg, vmem_budget=budget)
    ops.reset_launches()
    ms, d = _opt_step(torch, run["model"], cfg, run, run["key"])
    counts = ops.launch_counts()
    log(f"  Muon step with vmem_budget={budget}: {ms:.1f} ms, launches "
        f"{counts}")
    _expect_launches(counts, dict(matmul_add=10, gram_upper=10, warm_tail=1,
                                  sketch_step=24, residual_chain=2,
                                  apply_g=2), "fallback (sketch_step) path")
    worst = _worst_gap(torch, d, run["deltas"]["kernels"],
                       "sketch_step vs sketch_chain")
    log(f"  update through sketch_step vs through sketch_chain: worst "
        f"relative gap {worst:.3e} (bound {UPDATE_REL_TOL})")
    return counts


def profile_step(torch, run, what, fit_buckets=()):
    """A torch.profiler trace of one optimizer step through the kernels
    (``what`` names it): the device time of each of the port's kernels and
    of all other device work (memory copies and PyTorch's own kernels),
    against the step's wall time; and the alpha fit (the sketch draws and
    the closed-form fits, marked with record_function here): its host time
    (a clock around each call) and the device time of the kernels it
    launched.  ``fit_buckets``: (batch, fits a step) of each bucket whose
    closed-form fit is then timed alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import newton_schulz, prism, sketch

    fit_host = [0.0]

    def marked(fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            with record_function("alpha_fit"):
                out = fn(*a, **k)
            fit_host[0] += time.perf_counter() - t0
            return out
        return wrapper

    saved = (prism.fit_alpha_from_traces, sketch.gaussian_sketch)
    prism.fit_alpha_from_traces = marked(saved[0])
    sketch.gaussian_sketch = newton_schulz.sk.gaussian_sketch = \
        marked(saved[1])
    try:
        o = _opt_from(torch, run["model"], run["opt"].cfg, run["state"])
        _restore(torch, run["model"], run)
        o.step(key=run["key"])  # warm
        o = _opt_from(torch, run["model"], run["opt"].cfg, run["state"])
        _restore(torch, run["model"], run)
        torch.cuda.synchronize()
        fit_host[0] = 0.0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            o.step(key=run["key"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        prism.fit_alpha_from_traces = saved[0]
        sketch.gaussian_sketch = newton_schulz.sk.gaussian_sketch = saved[1]

    kernel_us, other_us, fit_dev_us, fit_calls = 0.0, 0.0, 0.0, 0
    per_kernel = dict.fromkeys(KERNEL_NAMES, 0.0)
    for e in prof.key_averages():
        if e.key == "alpha_fit":
            fit_dev_us = max(fit_dev_us, e.device_time_total)
            fit_calls = max(fit_calls, e.count)
        # device activity only; the GPU-side spans of record_function
        # ranges (Muon.step, alpha_fit) would count their kernels twice
        elif e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            name = next((n for n in KERNEL_NAMES
                         if f"{n}_kernel" in e.key), None)
            if name is not None:
                kernel_us += e.self_device_time_total
                per_kernel[name] += e.self_device_time_total / 1e3
            else:
                other_us += e.self_device_time_total
    busy_ms = (kernel_us + other_us) / 1e3
    fit_ms = fit_host[0] * 1e3
    log(f"  profiled {what} step: wall {wall_ms:.1f} ms; device busy "
        f"{busy_ms:.2f} ms (port kernels {kernel_us / 1e3:.2f} ms, other "
        f"device work {other_us / 1e3:.2f} ms); idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; port kernels: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in per_kernel.items() if v))
    log(f"  alpha fit ({fit_calls} marked calls): host {fit_ms:.2f} ms "
        f"({fit_ms / wall_ms:.3f} of the step's wall time), device "
        f"{fit_dev_us / 1e3:.3f} ms")
    # the fit alone, unprofiled: one closed-form fit from fp32 traces of
    # each bucket, times its fitted iterations a step
    from repro_torch.core import polynomials as poly

    pc = run["opt"].cfg.prism
    apoly = poly.newton_schulz_residual(pc.degree)
    lo, hi = pc.bounds
    per_fit = []
    for B, _ in fit_buckets:
        t = torch.rand((B, poly.max_trace_power(apoly) + 1), device="cuda")
        per_fit.append(time_ms(torch, lambda: prism.fit_alpha_from_traces(
            t, apoly, lo, hi)))
    if fit_buckets:
        log(f"  one closed-form fit alone (B = "
            + ", ".join(str(B) for B, _ in fit_buckets) + "): "
            + ", ".join(f"{v:.3f}" for v in per_fit) + " ms; "
            + f"{sum(v * k for v, (_, k) in zip(per_fit, fit_buckets)):.2f}"
            + " ms a step")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms)


def adaptive_runs(torch):
    """matfn.polar with a tol and a budget of 5 fitted iterations on a
    grid-tier bucket and a fused-tier one, inputs of condition 1 to 1e3:
    prints each slice's iterations and status, and holds the launches to
    the iterations that ran (2+d per fitted iteration on the grid tier, 2
    on the fused tier, one warm tail)."""
    from repro_torch.config import PrismConfig
    from repro_torch.core import matfn, prism
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    d, warm, budget = 2, 1, 5
    for shape, tier in (((40, 1024, 1024), "grid"), ((30, 64, 16),
                                                      "fused")):
        B, m, n = shape
        q, _ = torch.linalg.qr(randn(torch, (B, m, n), gen))
        cond = torch.linspace(0.0, 3.0, B, device="cuda")[:, None, None]
        a = q * 10.0 ** (-cond * torch.linspace(0.0, 1.0, n,
                                                device="cuda"))
        tol = 0.05 * n ** 0.5
        cfg = PrismConfig(degree=d, iterations=warm + budget,
                          warm_alpha_iters=warm, sketch_dim=8, tol=tol,
                          use_kernels=True)
        ops.reset_launches()
        x, used, status = matfn.polar(a, cfg=cfg, key=Key(5),
                                      return_iters=True, return_status=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if not bool(torch.isfinite(x).all()):
            fail(f"adaptive {tier}: non-finite result")
        used_l, status_l = used.tolist(), status.tolist()
        fitted = budget
        if prism.STATUS_MAXITER not in status_l:
            fitted = min(budget, max(used_l) - warm + 1)
        if tier == "grid":
            want = dict(gram_upper=warm + fitted, sketch_chain=fitted,
                        matmul_add=d * (warm + fitted))
        else:
            want = dict(warm_tail=1, residual_chain=fitted, apply_g=fitted)
        log(f"  adaptive {tier} {shape} tol {tol:.3g}: iters_used "
            f"{used_l}; status {status_l}; {fitted} fitted iterations ran; "
            f"launches {counts}")
        _expect_launches(counts, want, f"adaptive {tier}")


def shampoo_extras(torch, run):
    """On the fitted Shampoo path: a Shampoo with precondition_every=2 takes
    two steps from the saved state (count 0: it refreshes; count 1: it
    serves the cached inverse roots and must launch nothing); and one
    Shampoo step with matfn_method="eigh" (torch.linalg.eigh, the paper's
    baseline) is timed beside the one through the kernels."""
    import dataclasses

    from repro_torch.kernels import ops

    model = run["model"]
    cfg2 = dataclasses.replace(run["opt"].cfg, precondition_every=2)
    o = _opt_from(torch, model, cfg2, (run["state"][0], 0))
    _restore(torch, model, run)
    ops.reset_launches()
    o.step(key=run["key"])
    torch.cuda.synchronize()
    first = ops.launch_counts()
    ops.reset_launches()
    _restore(torch, model, run)
    o.step(key=run["key"].fold_in(1))
    torch.cuda.synchronize()
    second = ops.launch_counts()
    log(f"  precondition_every=2: step 0 launches {first}; step 1 launches "
        f"{second}")
    _expect_launches(first, PER_STEP["shampoo_fig5"],
                     "precondition_every=2, step 0")
    _expect_launches(second, {}, "precondition_every=2, step 1")
    cfg_e = dataclasses.replace(run["opt"].cfg, matfn_method="eigh")
    eigh_ms = [_opt_step(torch, model, cfg_e, run, run["key"])[0]
               for _ in range(3)]
    log("  Shampoo step with matfn_method='eigh' (torch.linalg.eigh): "
        + ", ".join(f"{t:.1f}" for t in eigh_ms) + " ms; through the "
        "kernels (fitted PRISM) "
        + ", ".join(f"{t:.1f}" for t in run["opt_ms"]["kernels"]) + " ms")
    return dict(eigh_ms=eigh_ms)


def adaptive_sqrtm_runs(torch):
    """matfn.sqrtm with a tol and a budget of 5 fitted iterations after one
    warm iteration on a grid-tier bucket and a fused-tier one, symmetric
    positive definite inputs of condition 1 to 1e3: prints each slice's
    iterations and status, and holds the launches to the iterations that
    ran (a fitted grid iteration: 1 matmul_add for Y X, one sketch_chain,
    2d matmul_add for the two Horner sides; a fitted fused one:
    residual_chain + apply_g; the warm iteration: 1 + 2d matmul_add, or one
    warm_tail)."""
    from repro_torch.config import PrismConfig
    from repro_torch.core import matfn, prism
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    d, warm, budget = 2, 1, 5
    for shape, tier in (((20, 1024, 1024), "grid"), ((30, 64, 64),
                                                      "fused")):
        B, n, _ = shape
        q, _ = torch.linalg.qr(randn(torch, shape, gen))
        cond = torch.linspace(0.0, 3.0, B, device="cuda")[:, None, None]
        lam = 10.0 ** (-cond * torch.linspace(0.0, 1.0, n, device="cuda"))
        a = (q * lam) @ q.transpose(-1, -2)
        tol = 0.05 * n ** 0.5
        cfg = PrismConfig(degree=d, iterations=warm + budget,
                          warm_alpha_iters=warm, sketch_dim=8, tol=tol,
                          use_kernels=True)
        ops.reset_launches()
        (x, y), used, status = matfn.sqrtm(a, cfg=cfg, key=Key(5),
                                           return_iters=True,
                                           return_status=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if not (bool(torch.isfinite(x).all()) and
                bool(torch.isfinite(y).all())):
            fail(f"adaptive sqrtm {tier}: non-finite result")
        used_l, status_l = used.tolist(), status.tolist()
        fitted = budget
        if prism.STATUS_MAXITER not in status_l:
            fitted = min(budget, max(used_l) - warm + 1)
        if tier == "grid":
            want = dict(matmul_add=(1 + 2 * d) * (warm + fitted),
                        sketch_chain=fitted)
        else:
            want = dict(warm_tail=1, residual_chain=fitted, apply_g=fitted)
        log(f"  adaptive sqrtm {tier} {shape} tol {tol:.3g}: iters_used "
            f"{used_l}; status {status_l}; {fitted} fitted iterations ran; "
            f"launches {counts}")
        _expect_launches(counts, want, f"adaptive sqrtm {tier}")


# --------------------------------------------------------------- main

def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA "
             "device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    # importing the package switches TF32 off
    from repro_torch.kernels import _build

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")

    log("phase 2: build")
    t0 = time.perf_counter()
    per_source = _build.build(verbose=True)
    log(f"  built {sorted(per_source) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas_summary(_build)

    log("phase 3: kernels against their plain versions")
    rows = kernel_checks(torch)
    rows = fit_kernel_checks(torch, rows)
    rows = family_checks(torch, rows)
    timings = kernel_timings(torch, rows)
    timings.update(fit_kernel_timings(torch, rows))
    timings.update(family_timings(torch))

    runs = {}
    log("phase 4: PRISM-5 path, gpt2-paper Muon step at full width")
    runs["prism5"] = train_path(torch, "prism5")
    _drop(torch, runs["prism5"])

    log("phase 5: PRISM-3 path (fitted iterations) at full width")
    run3 = runs["prism3"] = train_path(torch, "prism3")
    fallback = fallback_path(torch, run3)
    if len(run3["syncs"]) > len(runs["prism5"]["syncs"]):
        fail(f"the fitted iterations add synchronizing calls: PRISM-3 "
             f"{run3['syncs']} vs PRISM-5 {runs['prism5']['syncs']}")
    profile_step(torch, run3, "PRISM-3 Muon", ((40, 2), (20, 2), (30, 2)))
    log("  adaptive runs (tol, budget 5)")
    adaptive_runs(torch)
    _drop(torch, run3)

    log("phase 6: Shampoo PRISM-5 path, gpt2-paper step at full width")
    runs["shampoo_prism5"] = train_path(torch, "shampoo_prism5")
    profile_step(torch, runs["shampoo_prism5"], "Shampoo PRISM-5")
    _drop(torch, runs["shampoo_prism5"])

    log("phase 7: Shampoo fitted path (Fig. 5 PRISM) at full width")
    runf = runs["shampoo_fig5"] = train_path(torch, "shampoo_fig5")
    shampoo_extras(torch, runf)
    profile_step(torch, runf, "fitted Shampoo", ((30, 5), (30, 5), (100, 5)))
    if len(runf["syncs"]) > len(runs["shampoo_prism5"]["syncs"]):
        fail(f"the fitted iterations add synchronizing calls: fitted "
             f"{runf['syncs']} vs warm {runs['shampoo_prism5']['syncs']}")
    log("  synchronizing calls an optimizer step: "
        + ", ".join(f"{k} {len(r['syncs'])}" for k, r in runs.items())
        + f" (bound {SYNCS_BOUND}, K3's former alpha copy)")
    log("  adaptive sqrtm runs (tol, budget 5)")
    adaptive_sqrtm_runs(torch)
    _drop(torch, runf)

    by_path = {k: r["counts"] for k, r in runs.items()}
    by_path["fallback"] = fallback
    print(json.dumps({"kernels": kernel_rows(rows, timings, by_path)}),
          flush=True)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def ptxas_summary(build) -> None:
    """Registers, spills and static shared memory of each instantiation of
    K1 and K2 (a spill fails), and registers and spills of K5's, K6's and
    K7's, from the compiler's -Xptxas -v report of this build."""
    import re

    from repro_torch.kernels import matmul_add

    spills = []
    for name in ("matmul_add", "gram_upper"):
        text = build.LOGS.get(name)
        if text is None:
            log(f"  ptxas {name}: cached build, no report")
            continue
        for entry in text.split("Compiling entry function")[1:]:
            kernel = re.search(r"_kernelI(\w+?)Lb([01])E", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            what = (f"{'bf16' if 'bfloat16' in kernel.group(1) else 'fp32'}"
                    f" {'aligned' if kernel.group(2) == '1' else 'unaligned'}"
                    if kernel else "?")
            log(f"  ptxas {name} {what}: "
                f"{regs.group(1) if regs else '?'} registers, spill stores "
                f"{spill.group(1) if spill else '?'} B, spill loads "
                f"{spill.group(2) if spill else '?'} B, static smem "
                f"{smem.group(1) if smem else 0} B (+ dynamic "
                f"{matmul_add.smem_bytes()} B)")
            if spill and (spill.group(1) != "0" or spill.group(2) != "0"):
                spills.append(f"{name} {what}")
    if spills:
        fail(f"register spills in {spills}")
    for name in ("residual_chain", "apply_g"):
        for entry in (build.LOGS.get(name) or "").split(
                "Compiling entry function")[1:]:
            kernel = re.search(r"_kernelI(\w+?)Li?b?(\w+?)EE", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", entry)
            if kernel:
                log(f"  ptxas {name} "
                    f"{'bf16' if 'bfloat16' in kernel.group(1) else 'fp32'}"
                    f" {kernel.group(2)}: {regs.group(1) if regs else '?'} "
                    f"registers, spill stores "
                    f"{spill.group(1) if spill else '?'} B, spill loads "
                    f"{spill.group(2) if spill else '?'} B")
    text = build.LOGS.get("sketch_chain")
    for entry in (text or "").split("Compiling entry function")[1:]:
        kernel = re.search(r"sketch_chain_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                           entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        if kernel:
            log(f"  ptxas sketch_chain "
                f"{'bf16' if 'bfloat16' in kernel.group(1) else 'fp32'} "
                f"vec {kernel.group(2)} tile {kernel.group(3)}: "
                f"{regs.group(1) if regs else '?'} registers, spill stores "
                f"{spill.group(1) if spill else '?'} B, spill loads "
                f"{spill.group(2) if spill else '?'} B")


def _drop(torch, run):
    """Free a path's model, optimizer and saved tensors; keep its counts."""
    for k in ("model", "opt", "state", "before", "grads", "deltas"):
        run.pop(k, None)
    torch.cuda.empty_cache()


# The kernels line: for each kernel, the measurements of each family and
# main-path shape it was timed at, as (family, row/timing key, path); the
# first entry, the one this slice's path runs where it runs one, gives the
# kernel's top-level numbers.  Sign runs on no training path (signm only),
# nor do K1's and K2's bf16 rows (the paths' matfn dtype is fp32).
VARIANTS = {
    "matmul_add": [
        ("-", ("matmul_add", (100, 1024, 1024)), "shampoo_prism5"),
        ("-", ("matmul_add", (20, 4096, 1024)), "prism5"),
        ("-", ("matmul_add", (40, 1024, 1024)), "prism5"),
        ("-", ("matmul_add", (100, 1024, 1024), "bfloat16"), None),
        ("-", ("matmul_add", (20, 4096, 1024), "bfloat16"), None),
        ("-", ("matmul_add", (40, 1024, 1024), "bfloat16"), None)],
    "gram_upper": [
        ("polar", ("gram_upper", (20, 4096, 1024)), "prism3"),
        ("polar", ("gram_upper", (40, 1024, 1024)), "prism3"),
        ("polar", ("gram_upper", (20, 4096, 1024), "bfloat16"), None),
        ("polar", ("gram_upper", (40, 1024, 1024), "bfloat16"), None)],
    "warm_tail": [
        ("sqrt", ("warm_tail/sqrt", (30, 64, 64)), "shampoo_prism5"),
        ("sqrt", ("warm_tail/sqrt", (30, 16, 16)), "shampoo_prism5"),
        ("sign", ("warm_tail/sign", (30, 64, 64)), None),
        ("polar", ("warm_tail", (30, 64, 16)), "prism5")],
    "sketch_step": [
        ("-", ("sketch_step", (40, 1024, 1024)), "fallback")],
    "sketch_chain": [
        ("-", ("sketch_chain", (100, 1024, 1024, 10)), "shampoo_fig5"),
        ("-", ("sketch_chain", (40, 1024, 1024, 6)), "prism3"),
        ("-", ("sketch_chain", (20, 1024, 1024, 6)), "prism3")],
    "residual_chain": [
        ("sqrt", ("residual_chain/sqrt", (30, 64, 64)), "shampoo_fig5"),
        ("sqrt", ("residual_chain/sqrt", (30, 16, 16)), "shampoo_fig5"),
        ("sign", ("residual_chain/sign", (30, 64, 64)), None),
        ("polar", ("residual_chain", (30, 64, 16, 6)), "prism3")],
    "apply_g": [
        ("coupled", ("apply_g/coupled", (30, 64, 64)), "shampoo_fig5"),
        ("coupled", ("apply_g/coupled", (30, 16, 16)), "shampoo_fig5"),
        ("polar", ("apply_g", (30, 64, 16)), "prism3")],
}
REPLACES = {"matmul_add": "src/repro/kernels/matmul_add.py:55",
            "gram_upper": "src/repro/kernels/gram.py:81",
            "warm_tail": "src/repro/kernels/fused_iter.py:301",
            "sketch_step": "src/repro/kernels/sketch_traces.py:64",
            "sketch_chain": "src/repro/kernels/sketch_traces.py:163",
            "residual_chain": "src/repro/kernels/fused_iter.py:138",
            "apply_g": "src/repro/kernels/fused_iter.py:209"}


def kernel_rows(rows, timings, by_path):
    """The entries of the kernels line (see VARIANTS)."""
    out = []
    for name in KERNEL_NAMES:
        variants = []
        for family, key, path in VARIANTS[name]:
            t = timings[key]
            variants.append({
                "family": family, "shape": rows[key]["shape"],
                "path": path,
                "launches": by_path[path][name] if path else 0,
                "max_abs_err": rows[key]["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                "back_to_back_ms": t.get("b2b_ms"),
                "device_ms": t.get("device_ms"),
                "dtype": key[2] if len(key) > 2 else "float32"})
        top = variants[0]
        out.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "families": sorted({v["family"] for v in variants}),
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            **{k: top[k] for k in ("path", "launches", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "back_to_back_ms",
                                   "device_ms", "shape", "dtype")},
            "variants": variants})
    return out


if __name__ == "__main__":
    main()
