#!/usr/bin/env python3
"""Proof on one NVIDIA H100 that the PyTorch port builds, is right and trains.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

  1. the card: CUDA present, its name and power limit (nvidia-smi);
  2. build every kernel from src/repro_torch/kernels/csrc (one nvcc per
     source, all at once) and print the compiler's register/spill report;
  3. each kernel against its plain PyTorch version on the card, in fp32 and
     bf16, at the shapes the main paths give it and at ragged ones, with the
     reference's tolerances on results of unit scale (see ``check``); at
     every main-path shape, in fp32, the kernel, the plain version and one
     PyTorch library call (where one computes the same function) are timed
     with CUDA events (median of 20 launches);
  4. the PRISM-5 path: the gpt2-paper Muon/PRISM-5 training step at full
     width (seq 512, batch 4, random weights from seed 0), STEPS steps
     through ``repro_torch.launch.train_lm.build``; the launch counts are
     zeroed just before and read just after, and must be 19 a step
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
  6. the ``kernels`` JSON line, and last the ``ok`` JSON line.

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
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
WARM_TOL = {"float32": 2e-4, "bfloat16": 5e-2}     # tests/test_fused_iter.py
# K4/K5 traces (tests/test_kernels.py) and K6/K7 (tests/test_fused_iter.py)
FIT_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
DTYPES = ("float32", "bfloat16")  # dtypes of the phase 3 checks
KERNEL_NAMES = ("matmul_add", "gram_upper", "warm_tail", "sketch_step",
                "sketch_chain", "residual_chain", "apply_g")
# launches a training step, per PRISM configuration
PER_STEP = {
    "prism5": dict(matmul_add=12, gram_upper=6, warm_tail=1),
    "prism3": dict(matmul_add=10, gram_upper=10, warm_tail=1,
                   sketch_chain=4, residual_chain=2, apply_g=2),
}

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

def time_ms(torch, fn, reps: int = TIMED_REPS, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def poison(torch, shape, dtype) -> None:
    """Free a NaN-filled block of this size just before a kernel call: the
    caching allocator hands it to the kernel's output, so an output the
    kernel fails to write reads as NaN instead of stale, plausible data."""
    t = torch.full(tuple(shape), float("nan"), dtype=dtype, device="cuda")
    del t


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
    gemm_shapes = [(40, 1024, 1024), (20, 4096, 1024),      # main path
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
            if shape == (20, 4096, 1024) and dtype == "float32":
                rows["matmul_add"] = dict(shape=[list(shape), [B, n, n]],
                                          max_abs_err=err_mm)
                rows["gram_upper"] = dict(shape=[list(shape)],
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
    return rows


def spectrum_r(torch, B, n, gen, radius=0.95):
    """Symmetric [B, n, n] with eigenvalues +-radius in random directions
    (Q diag(+-radius) Q^T): every power keeps unit size, and consecutive
    powers differ (odd ones change sign), so the traces of a chain that
    mixes up its powers or buffers come out wrong by O(1)."""
    q, _ = torch.linalg.qr(randn(torch, (B, n, n), gen))
    d = radius * torch.sign(randn(torch, (B, 1, n), gen))
    return (q * d) @ q.transpose(-1, -2)


def fit_kernel_checks(torch, rows):
    """K4-K7 against their plain versions, fp32 and bf16, at the PRISM-3
    main-path shapes and at ragged ones.  Traces are checked per slice as
    [B, 1, powers] so that ``check`` scales per slice."""
    from repro_torch.kernels import fused_iter, ops, sketch_traces

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    # K5 / K4 on the grid-tier residual bucket: R with eigenvalues +-0.95,
    # St ~ N(0, 1/p): traces of unit size (|t_i| up to ~p)
    for shape, p in [((40, 1024, 1024), 8), ((3, 300, 300), 5),
                     ((2, 37, 37), 12)]:
        B, n, _ = shape
        r32 = spectrum_r(torch, B, n, gen)
        s32 = randn(torch, (p, n), gen, p ** -0.5)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            r, st = r32.to(dt), s32.t().contiguous().to(dt)
            for maxp in (6, 10):
                want = sketch_traces.plain_chain(r, st, maxp)
                poison(torch, (B, maxp), torch.float32)
                got = sketch_traces.sketch_chain(r, st, maxp)
                err = check(torch, "sketch_chain", (B, n, p, maxp), dtype,
                            got.reshape(B, 1, maxp),
                            want.reshape(B, 1, maxp), FIT_TOL[dtype])
                if shape[0] == 40 and dtype == "float32" and maxp == 6:
                    rows["sketch_chain"] = dict(
                        shape=[list(shape), [n, p], maxp], max_abs_err=err,
                        operands=(r, st))
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
                if shape == (30, 64, 16) and dtype == "float32" and \
                        maxp == 6:
                    rows["residual_chain"] = dict(
                        shape=[list(shape), [n, p], maxp],
                        max_abs_err=max(err_r, err_t), operands=(x, st))
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
    return rows


def fit_kernel_timings(torch, rows):
    """ms / plain_ms / bound_ms of one launch of K4-K7 at their main-path
    shapes, fp32.  No single PyTorch call computes any of them (a chain of
    products with a trace epilogue; a residual with its chain; a Horner
    chain with a per-slice alpha), so ``library_ms`` is null."""
    from repro_torch.kernels import fused_iter, ops, sketch_traces

    item = 4
    out = {}
    r, st = rows["sketch_chain"]["operands"]
    B, n, _ = r.shape
    p = st.shape[1]
    maxp = 6
    out["sketch_chain"] = dict(
        ms=time_ms(torch, lambda: sketch_traces.sketch_chain(r, st, maxp)),
        plain_ms=time_ms(torch, lambda: sketch_traces.plain_chain(
            r, st, maxp)),
        library_ms=None,
        # 2 n^2 p flops a power; R read once, St read, traces written
        bound=bound_ms(2.0 * B * maxp * n * n * p,
                       item * (B * n * n + n * p + B * maxp), "float32"))
    v = st.expand(B, n, p).contiguous()
    out["sketch_step"] = dict(
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
    out["residual_chain"] = dict(
        ms=time_ms(torch, lambda: fused_iter.residual_chain(x, st6, maxp)),
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
    out["apply_g"] = dict(
        ms=time_ms(torch, lambda: fused_iter.apply_g(xa, ra, alpha,
                                                     coeffs=coeffs)),
        plain_ms=time_ms(torch, lambda: fused_iter.plain_apply_g(
            xa, ra, alpha, coeffs=coeffs)),
        library_ms=None,
        bound=bound_ms(B * (2.0 * m * n * n + 3.0 * m * n),
                       item * (2 * B * m * n + B * n * n + B), "float32"))
    for name in ("sketch_chain", "sketch_step", "residual_chain", "apply_g"):
        t = out[name]
        log(f"  {name:14s} {str(rows[name]['shape']):30s} float32 kernel "
            f"{t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  library none"
            f"  bound {t['bound'][0]:.5f} ms ({t['bound'][1]})")
    return out


def kernel_timings(torch, rows):
    """ms / plain_ms / library_ms / bound_ms of one launch of each kernel at
    each main-path shape, fp32 (the main path's matfn dtype).  The JSON row
    of a kernel carries its largest main-path shape."""
    from repro_torch.kernels import fused_iter, gram, matmul_add, ops

    coeffs = ops._gd_coeffs(2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    item = 4
    main_shapes = [("matmul_add", (40, 1024, 1024)),
                   ("matmul_add", (20, 4096, 1024)),
                   ("gram_upper", (40, 1024, 1024)),
                   ("gram_upper", (20, 4096, 1024)),
                   ("warm_tail", (30, 64, 16))]
    out = {}
    for name, shape in main_shapes:
        B, m, n = shape
        if name == "warm_tail":
            x = rows["warm_tail"]["operands"][0]
            alphas, d = (1.45,) * 3, 2
            flops = len(alphas) * B * (m * n * (n + 1) + d * 2.0 * m * n * n
                                       + (3 * d + 1) * m * n)
            t = dict(
                ms=time_ms(torch, lambda: fused_iter.warm_tail(
                    x, alphas, coeffs=coeffs)),
                plain_ms=time_ms(torch, lambda: fused_iter.plain(
                    x, alphas, coeffs=coeffs)),
                library_ms=None,
                bound=bound_ms(flops, item * 2 * B * m * n + 4 * len(alphas),
                               "float32"))
        else:
            x = normalized(torch, shape, gen)
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
                                   "float32"))
            else:
                eye = torch.eye(n, device="cuda")
                xt = x.transpose(-1, -2)
                t = dict(
                    ms=time_ms(torch, lambda: gram.gram_upper(x)),
                    plain_ms=time_ms(torch, lambda: gram.plain(x)),
                    library_ms=time_ms(torch, lambda: torch.baddbmm(
                        eye, xt, x, alpha=-1.0)),
                    bound=bound_ms(1.0 * B * m * n * (n + 1),
                                   item * (B * m * n + B * n * n),
                                   "float32"))
            del x
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"  {name:10s} {str(shape):18s} float32 kernel {t['ms']:.4f} ms"
            f"  plain {t['plain_ms']:.4f} ms  library {lib} ms  bound "
            f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")
        if shape == tuple(rows[name]["shape"][0]):
            out[name] = t
    return out


# --------------------------------------------------------------- phases 4-5

def _clone_state(opt):
    return ({p: {k: v.clone() for k, v in st.items()}
             for p, st in opt.state.items()}, opt.count)


def _muon_from(torch, model, cfg, state):
    from repro_torch.optim import Muon

    opt = Muon(model.named_parameters(), cfg, model.logical_axes())
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


def _muon_step(torch, model, cfg, run, key):
    """One Muon update from the saved state, parameters and gradients;
    returns (milliseconds, parameter deltas)."""
    o = _muon_from(torch, model, cfg, run["state"])
    _restore(torch, model, run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o.step(key=key)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, {k: (p.detach() - run["before"][k])
                for k, p in model.named_parameters()}


def _worst_gap(torch, got, want, what):
    worst = 0.0
    for k, dk in got.items():
        dp = want[k]
        scale = float(dp.abs().max())
        rel = float((dk - dp).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if not rel <= UPDATE_REL_TOL:
            fail(f"{what}: Muon update of {k} differs by {rel:.3e} of the "
                 f"largest update entry (bound {UPDATE_REL_TOL})")
    return worst


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


def train_path(torch, prism):
    """The gpt2-paper Muon step at full width with PRISM configuration
    ``prism``: STEPS steps through the launcher's ``build``, the launch,
    loss and update gates, and the timings."""
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops
    from repro_torch.launch import train_lm

    model, opt, step, batch_fn, (seq, batch) = train_lm.build(
        "full", "prism", "float32", device="cuda", seed=0, prism=prism)
    pc = opt.cfg.prism
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model {model.cfg.name}: {n_params} params, seq {seq}, batch "
        f"{batch}, Muon {prism} (degree {pc.degree}, "
        f"{pc.warm_alpha_iters} warm of {pc.iterations} iterations, sketch "
        f"{pc.sketch_dim}), use_kernels=True, matfn_dtype float32")
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

    peak_mem = torch.cuda.max_memory_allocated()
    for i, (loss, t) in enumerate(zip(losses, times)):
        log(f"  step {i}: loss {loss:.4f}  {t:.1f} ms")
    step_ms = statistics.median(times[1:])
    log(f"  step time (median of steps 1..{STEPS - 1}): {step_ms:.1f} ms, "
        f"{seq * batch / (step_ms / 1e3):.0f} tokens/s, "
        f"max_memory_allocated {peak_mem / 2**30:.2f} GiB")
    log(f"  launches over {STEPS} steps: {counts}")
    per_step = PER_STEP[prism]
    _expect_launches(counts, {k: v * STEPS for k, v in per_step.items()},
                     f"{prism} ({sum(per_step.values())} a step: "
                     f"{per_step})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss: {losses}")
    ln_v = math.log(model.cfg.vocab_size)
    if abs(losses[0] - ln_v) > 1.5:
        fail(f"first loss {losses[0]:.4f} not within 1.5 of ln(V) "
             f"{ln_v:.4f}")

    # one Muon update through the kernels vs through the plain versions,
    # on the clipped gradients the last step left in .grad, with the key
    # the next step would use
    run = dict(model=model, opt=opt, key=Key(0).fold_in(STEPS),
               before={k: p.detach().clone()
                       for k, p in model.named_parameters()},
               grads={k: p.grad.clone()
                      for k, p in model.named_parameters()},
               state=_clone_state(opt), counts=counts, step_ms=step_ms)
    deltas, muon_ms = {}, {"kernels": [], "plain": []}
    for tag in ("kernels", "plain", "plain", "kernels"):
        cfg = _with_prism(opt.cfg, use_kernels=tag == "kernels")
        ms, d = _muon_step(torch, model, cfg, run, run["key"])
        muon_ms[tag].append(ms)
        deltas.setdefault(tag, d)
    worst = _worst_gap(torch, deltas["kernels"], deltas["plain"],
                       f"{prism} kernels vs plain")
    run.update(deltas=deltas, muon_ms=muon_ms)
    # forward + backward alone (the rest of a step is clipping and Muon)
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
    log(f"  Muon update, kernels vs plain versions: worst relative gap "
        f"{worst:.3e} (bound {UPDATE_REL_TOL})")
    log("  Muon step through the kernels "
        + ", ".join(f"{t:.1f}" for t in muon_ms["kernels"])
        + " ms; through torch.matmul (use_kernels=False) "
        + ", ".join(f"{t:.1f}" for t in muon_ms["plain"]) + " ms")
    # the synchronizing calls of one Muon step through the kernels
    o = _muon_from(torch, model, opt.cfg, run["state"])
    _restore(torch, model, run)
    run["syncs"] = count_syncs(torch, lambda: o.step(key=run["key"]))
    log(f"  synchronizing calls in one Muon step: {len(run['syncs'])} "
        f"{sorted(set(run['syncs']))}")
    return run


def fallback_path(torch, run):
    """One PRISM-3 Muon step with the shared-memory budget forced just
    below sketch_chain's footprint on the grid buckets' Gram side (96 KiB
    at d_model = 1024, fp32, p = 8; the fused tier's bias view needs 13 KB
    and keeps its tier): the chains run as sketch_step launches (2 buckets
    x 2 fits x 6 powers), and the update stays within UPDATE_REL_TOL of
    the update through sketch_chain."""
    from repro_torch.kernels import ops, sketch_traces

    pc = run["opt"].cfg.prism
    budget = sketch_traces.chain_smem_bytes(
        run["model"].cfg.d_model, pc.sketch_dim, 4) - 16
    cfg = _with_prism(run["opt"].cfg, vmem_budget=budget)
    ops.reset_launches()
    ms, d = _muon_step(torch, run["model"], cfg, run, run["key"])
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


def profile_muon(torch, run):
    """A torch.profiler trace of one PRISM-3 Muon step through the kernels:
    the device time of the port's kernels and of all other device work
    (memory copies and PyTorch's own kernels), against the step's wall
    time; and the alpha fit (the sketch draws and the closed-form fits,
    marked with record_function here): its host time (a clock around each
    call) and the device time of the kernels it launched."""
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
        o = _muon_from(torch, run["model"], run["opt"].cfg, run["state"])
        _restore(torch, run["model"], run)
        o.step(key=run["key"])  # warm
        o = _muon_from(torch, run["model"], run["opt"].cfg, run["state"])
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

    ours = tuple(f"{n}_kernel" for n in KERNEL_NAMES)
    kernel_us, other_us, fit_dev_us, fit_calls = 0.0, 0.0, 0.0, 0
    for e in prof.key_averages():
        if e.key == "alpha_fit":
            fit_dev_us = max(fit_dev_us, e.device_time_total)
            fit_calls = max(fit_calls, e.count)
        # device activity only; the GPU-side spans of record_function
        # ranges (Muon.step, alpha_fit) would count their kernels twice
        elif e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            if any(n in e.key for n in ours):
                kernel_us += e.self_device_time_total
            else:
                other_us += e.self_device_time_total
    busy_ms = (kernel_us + other_us) / 1e3
    fit_ms = fit_host[0] * 1e3
    log(f"  profiled Muon step: wall {wall_ms:.1f} ms; device busy "
        f"{busy_ms:.2f} ms (port kernels {kernel_us / 1e3:.2f} ms, other "
        f"device work {other_us / 1e3:.2f} ms); idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    log(f"  alpha fit ({fit_calls} marked calls): host {fit_ms:.2f} ms "
        f"({fit_ms / wall_ms:.3f} of the step's wall time), device "
        f"{fit_dev_us / 1e3:.3f} ms")
    # the fit alone, unprofiled: one closed-form fit from fp32 traces of
    # each PRISM-3 bucket (two fitted iterations each per step)
    from repro_torch.core import polynomials as poly

    pc = run["opt"].cfg.prism
    apoly = poly.newton_schulz_residual(pc.degree)
    lo, hi = pc.bounds
    per_fit = []
    for B in (40, 20, 30):
        t = torch.rand((B, poly.max_trace_power(apoly) + 1), device="cuda")
        per_fit.append(time_ms(torch, lambda: prism.fit_alpha_from_traces(
            t, apoly, lo, hi)))
    log(f"  one closed-form fit alone (B = 40, 20, 30): "
        + ", ".join(f"{v:.3f}" for v in per_fit) + f" ms; two a bucket: "
        f"{2 * sum(per_fit):.2f} ms a step")
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

    log("phase 3: kernels against their plain versions")
    rows = kernel_checks(torch)
    rows = fit_kernel_checks(torch, rows)
    timings = kernel_timings(torch, rows)
    timings.update(fit_kernel_timings(torch, rows))

    log("phase 4: PRISM-5 path, gpt2-paper training step at full width")
    run5 = train_path(torch, "prism5")
    for k in ("model", "opt", "state", "before", "grads", "deltas"):
        del run5[k]
    torch.cuda.empty_cache()

    log("phase 5: PRISM-3 path (fitted iterations) at full width")
    run3 = train_path(torch, "prism3")
    fallback = fallback_path(torch, run3)
    if len(run3["syncs"]) > len(run5["syncs"]):
        fail(f"the fitted iterations add synchronizing calls: PRISM-3 "
             f"{run3['syncs']} vs PRISM-5 {run5['syncs']}")
    log(f"  synchronizing calls a Muon step: PRISM-5 {len(run5['syncs'])}, "
        f"PRISM-3 {len(run3['syncs'])} (the fit adds none)")
    profile_muon(torch, run3)
    log("  adaptive runs (tol, budget 5)")
    adaptive_runs(torch)

    replaces = {"matmul_add": "src/repro/kernels/matmul_add.py:55",
                "gram_upper": "src/repro/kernels/gram.py:81",
                "warm_tail": "src/repro/kernels/fused_iter.py:301",
                "sketch_step": "src/repro/kernels/sketch_traces.py:64",
                "sketch_chain": "src/repro/kernels/sketch_traces.py:163",
                "residual_chain": "src/repro/kernels/fused_iter.py:138",
                "apply_g": "src/repro/kernels/fused_iter.py:209"}
    by_path = {"prism5": run5["counts"], "prism3": run3["counts"],
               "fallback": fallback}
    kernels = []
    for name in KERNEL_NAMES:
        t = timings[name]
        path = "fallback" if name == "sketch_step" else "prism3"
        kernels.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "path": path,
            "launches": by_path[path][name],
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            "max_abs_err": rows[name]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "shape": rows[name]["shape"], "dtype": "float32"})
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
