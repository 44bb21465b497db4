#!/usr/bin/env python3
"""Proof on one NVIDIA H100 that the PyTorch port builds, is right and trains.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

  1. the card: CUDA present, its name and power limit (nvidia-smi);
  2. build every kernel from src/repro_torch/kernels/csrc (one nvcc per
     source, all at once) and print the compiler's register/spill report;
  3. each kernel against its plain PyTorch version on the card, in fp32 and
     bf16, at the shapes the main path gives it and at ragged ones, with the
     reference's tolerances on results of unit scale (see ``check``); at
     every main-path shape, in fp32, the kernel, the plain version and one
     PyTorch library call are timed with CUDA events (median of 20
     launches);
  4. the main path: the gpt2-paper Muon/PRISM-5 training step at full width
     (seq 512, batch 4, random weights from seed 0), STEPS steps through
     ``repro_torch.launch.train_lm.build``; the launch counts are zeroed just
     before and read just after, and must be 19 a step (matmul_add 12,
     gram_upper 6, warm_tail 1); the losses must be finite and start near
     ln(50257); one Muon update through the kernels must agree with the same
     update through the plain versions (``use_kernels=False``); the Muon
     step and the forward+backward pass are timed on their own;
  5. the ``kernels`` JSON line, and last the ``ok`` JSON line.

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
        for dtype in ("float32", "bfloat16"):
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
                rows["matmul_add"] = dict(shape=[shape, [B, n, n]],
                                          max_abs_err=err_mm)
                rows["gram_upper"] = dict(shape=[shape], max_abs_err=err_g)

    # K3 on the bias bucket (3 warm iterations of alpha = u = 1.45)
    for shape in [(30, 64, 16), (5, 55, 23)]:
        x32 = normalized(torch, shape, gen)
        for dtype in ("float32", "bfloat16"):
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
                rows["warm_tail"] = dict(shape=[shape], operands=(x,),
                                         max_abs_err=err)
    return rows


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


# --------------------------------------------------------------- phase 4

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


def main_path(torch):
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch import train_lm

    model, opt, step, batch_fn, (seq, batch) = train_lm.build(
        "full", "prism", "float32", device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model {model.cfg.name}: {n_params} params, seq {seq}, batch "
        f"{batch}, Muon PRISM-5 (degree 2, 3 warm iterations), "
        f"use_kernels=True, matfn_dtype float32")
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
    want = {"matmul_add": 12 * STEPS, "gram_upper": 6 * STEPS,
            "warm_tail": 1 * STEPS}
    if counts != want:
        fail(f"launches {counts}, want {want} (19 a step: 12/6/1)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss: {losses}")
    ln_v = math.log(model.cfg.vocab_size)
    if abs(losses[0] - ln_v) > 1.5:
        fail(f"first loss {losses[0]:.4f} not within 1.5 of ln(V) "
             f"{ln_v:.4f}")

    # one Muon update through the kernels vs through the plain versions,
    # on the clipped gradients the last step left in .grad
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = _clone_state(opt)
    deltas, muon_ms = {}, {"kernels": [], "plain": []}
    for tag in ("kernels", "plain", "plain", "kernels"):
        cfg = dataclasses.replace(opt.cfg, prism=dataclasses.replace(
            opt.cfg.prism, use_kernels=tag == "kernels"))
        o = _muon_from(torch, model, cfg, state)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(before[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o.step()
        torch.cuda.synchronize()
        muon_ms[tag].append((time.perf_counter() - t0) * 1e3)
        deltas.setdefault(tag, {k: (p.detach() - before[k])
                                for k, p in model.named_parameters()})
    worst = 0.0
    for k, dk in deltas["kernels"].items():
        dp = deltas["plain"][k]
        scale = float(dp.abs().max())
        rel = float((dk - dp).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if not rel <= UPDATE_REL_TOL:
            fail(f"Muon update of {k}: kernels vs plain differ by {rel:.3e}"
                 f" of the largest update entry (bound {UPDATE_REL_TOL})")
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
    return counts


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
    timings = kernel_timings(torch, rows)

    log("phase 4: main path, gpt2-paper training step at full width")
    counts = main_path(torch)

    replaces = {"matmul_add": "src/repro/kernels/matmul_add.py:55",
                "gram_upper": "src/repro/kernels/gram.py:81",
                "warm_tail": "src/repro/kernels/fused_iter.py:301"}
    sources = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
               for name in replaces}
    kernels = []
    for name in ("matmul_add", "gram_upper", "warm_tail"):
        t = timings[name]
        kernels.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": rows[name]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "shape": [list(s) for s in rows[name]["shape"]],
            "dtype": "float32"})
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
