#!/usr/bin/env python3
"""Time the fused-tier kernels K3 ``warm_tail``, K6 ``residual_chain`` and
K7 ``apply_g`` of one or two source trees at the main paths' shapes and
families, beside their plain versions, on a CUDA card, and check that the
trees give bitwise-equal results.

For each tree (``--tree``, default this checkout; give two, e.g. an
unpacked ``git archive`` of the parent and this checkout, to compare them
in one call) the script copies ``<tree>/src`` into
``build/probe/fused-<i>-<name>/`` (git-ignored), builds that copy's K3, K6
and K7 with ``-Xptxas -v`` (registers and spills are printed) and, in its
own process, on inputs made from one seed:

  * K3: sqrt [30, 64, 64] and [30, 16, 16] (Shampoo PRISM-5: 3 warm
    iterations of degree 2, X symmetric positive definite, Y = I), polar
    [30, 64, 16] (Muon PRISM-5);
  * K6: sqrt [30, 64, 64] and [30, 16, 16] x 10 powers (fitted Shampoo),
    and with no power (the residual alone; its plain version is the plain
    residual), polar [30, 64, 16] x 6 powers (Muon PRISM-3), p = 8;
  * K7: coupled [30, 64, 64] and [30, 16, 16] of degree 2, polar
    [30, 64, 16] of degree 1, a different alpha in every slice;

it prints the median of 20 single launches between two CUDA events (the
host's launch time is inside, as in chip_smoke.py's phase 3), the median
of 20 runs of 10 launches back to back (the device's time, unless the
kernel is shorter than the host's time to launch it), the mean device time
of a launch in a ``torch.profiler`` trace of 20 (the device's time in any
case), the plain version's single-launch median, and the median SM clock
and board power that ``nvidia-smi`` sampled while each kernel ran back to
back for half a second at its largest shape.  fp32, or bf16 with
``--dtype``.  Each process saves its outputs (K3's X' and Y', K6's R and
traces, K7's X' and Y'); the script then prints, for every case, whether
the trees' outputs are bitwise equal (R, X', Y') and how far the traces
differ (a redesign may sum them in another order).  With two trees the
timing runs go tree 1, tree 2, tree 2, tree 1, so that a drift of the
card's clock shows.
Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/fused_probe.py [--tree DIR ...] [--dtype float32|bfloat16]

Print only its ``^probe`` lines: the nvcc log is long.  Exits non-zero when
a tree fails to build or run, or when the trees' R, X' or Y' differ.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("warm_tail", "residual_chain", "apply_g")

PROBE = r"""
import contextlib, io, re, statistics, subprocess, sys, time
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import _build, fused_iter, ops, ref

dtype = getattr(torch, sys.argv[1])
out_file, tag = sys.argv[2], sys.argv[3]
kernels = ("warm_tail", "residual_chain", "apply_g")
_build.KERNELS = kernels
with contextlib.redirect_stdout(io.StringIO()):  # the summary below
    _build.build(kernels, verbose=True)
for name in kernels:
    for entry in _build.LOGS.get(name, "").split(
            "Compiling entry function")[1:]:
        kernel = re.search(r"_kernelI(\w+?)E", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        if kernel and regs and spill:
            print(f"probe {tag} ptxas {name} {kernel.group(1)}: "
                  f"{regs.group(1)} registers, spill stores "
                  f"{spill.group(1)} B, spill loads {spill.group(2)} B",
                  flush=True)


def ms(fn, reps=20, warmup=3, batch=1):
    # median over reps of the time of `batch` launches back to back, per
    # launch; batch = 1 includes the host's launch time, 10 is the device's
    # for a kernel that runs longer than the host takes to launch it
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / batch)
    return statistics.median(out)


def device_ms(fn, kernel, reps=20):
    # mean device time of one launch of `kernel` (CUDA kernels whose name
    # holds it) over reps launches, from a torch.profiler trace: what a
    # launch costs the card, whatever the host's launch time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and kernel in e.key:
            total += e.self_device_time_total
            count += e.count
    return total / 1e3 / count if count else float("nan")


def clocks(fn, seconds=0.5):
    # median SM clock (MHz) and board power (W) that nvidia-smi samples
    # while fn runs back to back for about `seconds`
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
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
gen.manual_seed(17)


def randn(shape, scale=1.0):
    return scale * torch.randn(shape, generator=gen, device="cuda")


def spd(B, n):
    q, _ = torch.linalg.qr(randn((B, n, n)))
    lam = 0.05 + 0.95 * torch.rand((B, 1, n), generator=gen, device="cuda")
    a = (q * lam) @ q.transpose(-1, -2)
    return a / torch.linalg.matrix_norm(a, keepdim=True)


coeffs2 = ops._gd_coeffs(2)
warm = (1.45,) * 3
cases = []   # (name, shape, kernel, plain, largest)
for n in (64, 16):
    shape = (30, n, n)
    a = spd(30, n).to(dtype)
    eye = torch.eye(n, device="cuda", dtype=dtype).expand(shape).contiguous()
    y = randn(shape, 0.5 * n ** -0.5).to(dtype)
    S = randn((8, n), 8 ** -0.5).to(dtype)
    st = S.t().contiguous()
    r = ops.residual_chain(a, S, 10, family="sqrt", Y=eye)[0].contiguous()
    alpha = torch.linspace(0.375, 1.45, 30, device="cuda")
    xa, ya = randn(shape).to(dtype), randn(shape).to(dtype)
    cases += [
        ("warm_tail/sqrt", shape + (3,),
         lambda a=a, eye=eye: fused_iter.warm_tail(
             a, warm, coeffs=coeffs2, family="sqrt", Y=eye),
         lambda a=a, eye=eye: fused_iter.plain(
             a, warm, coeffs=coeffs2, family="sqrt", Y=eye), n == 64),
        ("residual_chain/sqrt", shape + (10,),
         lambda a=a, st=st, y=y: fused_iter.residual_chain(
             a, st, 10, family="sqrt", Y=y),
         lambda a=a, S=S, y=y: fused_iter.plain_residual_chain(
             a, S, 10, family="sqrt", Y=y), n == 64),
        # the residual alone: the chain's share is the difference
        ("residual_chain/sqrt", shape + (0,),
         lambda a=a, st=st, y=y: fused_iter.residual_chain(
             a, st, 0, family="sqrt", Y=y),
         lambda a=a, y=y: ref._residual(a, y, family="sqrt"), False),
        ("apply_g/coupled", shape + (2,),
         lambda xa=xa, r=r, alpha=alpha, ya=ya: fused_iter.apply_g(
             xa, r, alpha, coeffs=coeffs2, Y=ya),
         lambda xa=xa, r=r, alpha=alpha, ya=ya: fused_iter.plain_apply_g(
             xa, r, alpha, coeffs=coeffs2, Y=ya), n == 64)]
shape = (30, 64, 16)
x = randn(shape, (0.9 / 64) ** 0.5).to(dtype)
xw = (x / torch.linalg.matrix_norm(x.float(), keepdim=True)).to(dtype)
S = randn((8, 16), 8 ** -0.5).to(dtype)
st = S.t().contiguous()
r16 = ops.residual_chain(x, S, 6)[0].contiguous()
xa = randn(shape).to(dtype)
alpha = torch.linspace(0.5, 1.0, 30, device="cuda")
coeffs1 = ops._gd_coeffs(1)
cases += [
    ("warm_tail", shape + (3,),
     lambda: fused_iter.warm_tail(xw, warm, coeffs=coeffs2),
     lambda: fused_iter.plain(xw, warm, coeffs=coeffs2), True),
    ("residual_chain", shape + (6,),
     lambda: fused_iter.residual_chain(x, st, 6),
     lambda: fused_iter.plain_residual_chain(x, S, 6), True),
    ("apply_g", shape + (1,),
     lambda: fused_iter.apply_g(xa, r16, alpha, coeffs=coeffs1),
     lambda: fused_iter.plain_apply_g(xa, r16, alpha, coeffs=coeffs1),
     True)]

saved = {}
for name, shape, kern, plain, largest in cases:
    out = kern()
    torch.cuda.synchronize()
    saved[f"{name} {shape}"] = [o.cpu() for o in
                                (out if isinstance(out, tuple) else (out,))]
    k1 = ms(kern)
    k10 = ms(kern, batch=10)
    dev = device_ms(kern, name.split("/")[0] + "_kernel")
    p1 = ms(plain)
    line = (f"probe {tag} {name} {shape} {sys.argv[1]}: kernel {k1:.4f} ms "
            f"(back to back {k10:.4f} ms, profiled device {dev:.4f} ms) "
            f"plain {p1:.4f} ms")
    if largest:
        mhz, watt = clocks(kern)
        line += f"; sm clock {mhz:.0f} MHz, power {watt:.0f} W"
    print(line, flush=True)
torch.save(saved, out_file)
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, nargs="+", default=[ROOT])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    dirs = []
    for i, tree in enumerate(args.tree):
        d = ROOT / "build" / "probe" / f"fused-{i}-{tree.resolve().name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(tree / "src", d / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        dirs.append(d)
    order = list(range(len(dirs)))
    if len(dirs) == 2:
        order = [0, 1, 1, 0]
    code = 0
    for run, i in enumerate(order):
        print(f"probe run {run}: tree {i} {args.tree[i]}", flush=True)
        r = subprocess.run([sys.executable, "-c", PROBE, args.dtype,
                            str(dirs[i] / f"outputs-{run}.pt"),
                            f"tree{i}"], cwd=dirs[i], timeout=900)
        code = code or r.returncode
    if code:
        sys.exit(code)
    if len(dirs) > 1:
        import torch

        first = torch.load(dirs[0] / "outputs-0.pt")
        for i in range(1, len(dirs)):
            other = torch.load(dirs[i] / f"outputs-{order.index(i)}.pt")
            for key, outs in first.items():
                theirs = other[key]
                if key.startswith("residual_chain"):
                    same = torch.equal(outs[0], theirs[0])
                    t0, t1 = outs[1], theirs[1]
                    dt = float((t0 - t1).abs().amax()) if t0.numel() else 0.
                    scale = float(t0.abs().amax()) if t0.numel() else 0.
                    print(f"probe bitwise tree0 vs tree{i} {key}: R "
                          f"{'equal' if same else 'DIFFERS'}; traces "
                          f"max |diff| {dt:.3e} (largest |t| {scale:.3e})",
                          flush=True)
                else:
                    same = all(torch.equal(a, b)
                               for a, b in zip(outs, theirs))
                    print(f"probe bitwise tree0 vs tree{i} {key}: "
                          f"{' and '.join(('X′', 'Y′')[:len(outs)])} "
                          f"{'equal' if same else 'DIFFER'}", flush=True)
                code = code or not same
    sys.exit(int(bool(code)))


if __name__ == "__main__":
    main()
