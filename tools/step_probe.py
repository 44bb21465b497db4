#!/usr/bin/env python3
"""Time K4 ``sketch_step`` (one power of the sketched chain, V' = R V and
its trace) of one or two source trees on a CUDA card, beside its plain
version, and compare the trees' outputs.

For each tree (``--tree``, default this checkout; give two, e.g. an
unpacked ``git archive`` of the parent and this checkout, to compare them
in one call) the script copies ``<tree>/src`` into
``build/probe/step-<i>-<name>/`` (git-ignored), builds that copy's K4 with
``-Xptxas -v`` (registers and spills are printed) and, in its own process,
on inputs made from one seed (R symmetric with eigenvalues +-0.95, V = St,
p = 8, fp32 or bf16 with ``--dtype``), at [40, 1024, 1024] and
[20, 1024, 1024] (the fallback step's buckets) and [4, 4096, 4096] (a
shape only K4 takes), prints:

  * the median of 20 single launches between two CUDA events (the host's
    time to launch, and any other launch the wrapper makes, inside);
  * the median of 20 runs of 10 launches back to back;
  * the mean device time of one launch of ``sketch_step_kernel`` in a
    ``torch.profiler`` trace of 20, and the device time of every other
    kernel the 20 calls launched (the parent's wrapper zeroed its
    counters with a fill kernel before every launch);
  * R's streamed rate (its bytes over the profiled device time) and the
    device-memory bound (R, V and St read once, V' and t' written, over
    3.35 TB/s);
  * the plain version's single-launch median, and the largest difference
    of V' and t' from it;
  * whether two launches give bitwise-equal V' and traces;
  * the median SM clock and board power that ``nvidia-smi`` sampled while
    K4 ran back to back for half a second at [40, 1024, 1024].

With two trees the runs go tree 1, tree 2, tree 2, tree 1, so that a
drift of the card's clock shows, and the script prints how far the trees'
V' and traces differ (a redesign may sum them in another order).
``--change NAME ...`` adds named variants of this checkout's K4
(``CHANGES``) as further trees.  Run from the root of a checkout, on a
machine with a CUDA card and nvcc:

    python3 tools/step_probe.py [--tree DIR ...] [--dtype float32|bfloat16]
        [--change NAME ...]

Print only its ``^probe`` lines: the nvcc log is long.  Exits non-zero when
a tree fails to build or run, or when two launches of a tree differ.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# variants of this checkout's K4 (``--change``): name -> [(file under
# src/repro_torch/kernels, text, replacement), ...]
CHANGES = {
    # R's ring three or four slots deep: two or three k steps in flight
    "stages3": [("csrc/sketch_step.cu", "constexpr int STAGES = 2;",
                 "constexpr int STAGES = 3;")],
    "stages4": [("csrc/sketch_step.cu", "constexpr int STAGES = 2;",
                 "constexpr int STAGES = 4;")],
    # 4 rows a warp at p <= 8 (32 sums a lane; V' keeps its order)
    "rows4": [("csrc/sketch_step.cu", "constexpr int GROUP_SUMS = 64;",
               "constexpr int GROUP_SUMS = 32;"),
              ("sketch_traces.py", "STEP_GROUP_SUMS = 64",
               "STEP_GROUP_SUMS = 32")],
}
# ... and with two blocks an SM (at most 128 registers a thread)
CHANGES["rows4_two_blocks"] = CHANGES["rows4"] + [(
    "csrc/sketch_step.cu", "__launch_bounds__(THREADS, 1)",
    "__launch_bounds__(THREADS, 2)")]

PROBE = r"""
import contextlib, io, re, statistics, subprocess, sys, time
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import _build, sketch_traces

dtype = getattr(torch, sys.argv[1])
out_file, tag = sys.argv[2], sys.argv[3]
item = torch.empty((), dtype=dtype).element_size()
_build.KERNELS = ("sketch_step",)
with contextlib.redirect_stdout(io.StringIO()):  # the summary below
    _build.build(("sketch_step",), verbose=True)
for entry in _build.LOGS.get("sketch_step", "").split(
        "Compiling entry function")[1:]:
    kernel = re.search(r"sketch_step_kernelI(\w+?)Li(\d+)ELi(\d+)E", entry)
    regs = re.search(r"Used (\d+) registers", entry)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      entry)
    if kernel and regs and spill:
        print(f"probe {tag} ptxas {kernel.group(1)[-8:]} vec "
              f"{kernel.group(2)} tile {kernel.group(3)}: {regs.group(1)} "
              f"registers, spill stores {spill.group(1)} B, spill loads "
              f"{spill.group(2)} B", flush=True)


def ms(fn, reps=20, warmup=3, batch=1):
    # median over reps of the time of `batch` launches back to back, per
    # launch (batch = 1: the host's launch time inside)
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


def device_ms(fn, reps=20):
    # (mean device time of one sketch_step_kernel launch, device time of
    # all other kernels per call) from a torch.profiler trace of reps calls
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    k_total, k_count, other = 0.0, 0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "sketch_step_kernel" in e.key:
            k_total += e.self_device_time_total
            k_count += e.count
        else:
            other += e.self_device_time_total
    kernel = k_total / 1e3 / k_count if k_count else float("nan")
    return kernel, other / 1e3 / reps


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
gen.manual_seed(11)
p = 8
saved, code = {}, 0
for nb, n in ((40, 1024), (20, 1024), (4, 4096)):
    q, _ = torch.linalg.qr(torch.randn((nb, n, n), generator=gen,
                                       device="cuda"))
    d = 0.95 * torch.sign(torch.randn((nb, 1, n), generator=gen,
                                      device="cuda"))
    r = ((q * d) @ q.transpose(-1, -2)).to(dtype)
    del q
    st = (torch.randn((n, p), generator=gen, device="cuda")
          * p ** -0.5).to(dtype)
    v = st.expand(nb, n, p).contiguous()
    step = lambda: sketch_traces.sketch_step(r, v, st)
    got_v, got_t = step()
    again_v, again_t = step()
    torch.cuda.synchronize()
    same = torch.equal(got_v, again_v) and torch.equal(got_t, again_t)
    code = code or not same
    want_v, want_t = sketch_traces.plain_step(r, v, st)
    err_v = float((got_v.float() - want_v.float()).abs().max())
    err_t = float((got_t - want_t).abs().max())
    saved[f"{nb},{n}"] = (got_v.cpu(), got_t.cpu())
    k1 = ms(step)
    k10 = ms(step, batch=10)
    dev, other = device_ms(step)
    p1 = ms(lambda: sketch_traces.plain_step(r, v, st))
    nbytes = item * (nb * n * n + 2 * nb * n * p + n * p) + 4 * nb
    bound = nbytes / 3.35e12 * 1e3
    line = (f"probe {tag} sketch_step ({nb}, {n}, {n}) p {p} {sys.argv[1]}: "
            f"kernel {k1:.4f} ms (back to back {k10:.4f} ms, profiled "
            f"device {dev:.4f} ms, other kernels {other:.4f} ms a call) "
            f"plain {p1:.4f} ms; bound {bound:.4f} ms (bytes), "
            f"{bound / dev:.3f} of it; R streamed at "
            f"{item * nb * n * n / dev / 1e6:.1f} GB/s; max |V' - plain| "
            f"{err_v:.3e}, max |t' - plain| {err_t:.3e}; two launches "
            f"{'bitwise equal' if same else 'DIFFER'}")
    if (nb, n) == (40, 1024):
        mhz, watt = clocks(step)
        line += f"; sm clock {mhz:.0f} MHz, power {watt:.0f} W"
    print(line, flush=True)
    del r, v, st
torch.save(saved, out_file)
sys.exit(int(code))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, nargs="+", default=[ROOT])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--change", nargs="*", default=[],
                    help="also time these variants of this checkout")
    args = ap.parse_args()
    for change in args.change:
        if change not in CHANGES:
            raise SystemExit(f"unknown change {change}: one of "
                             f"{sorted(CHANGES)}")
    names = [t.resolve().name for t in args.tree] + list(args.change)
    sources = list(args.tree) + [ROOT] * len(args.change)
    dirs = []
    for i, (name, tree) in enumerate(zip(names, sources)):
        d = ROOT / "build" / "probe" / f"step-{i}-{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(tree / "src", d / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for source, text, replacement in CHANGES.get(name, []) \
                if i >= len(args.tree) else []:
            f = d / "src" / "repro_torch" / "kernels" / source
            code = f.read_text()
            if text not in code:
                raise SystemExit(f"{name}: the text to change is not in "
                                 f"{source}")
            f.write_text(code.replace(text, replacement))
        dirs.append(d)
    order = [0, 1, 1, 0] if len(dirs) == 2 else list(range(len(dirs)))
    code = 0
    for run, i in enumerate(order):
        print(f"probe run {run}: tree {i} {names[i]}", flush=True)
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
            for key, (v0, t0) in first.items():
                v1, t1 = other[key]
                dv = float((v0.float() - v1.float()).abs().max())
                dt = float((t0 - t1).abs().max())
                same = torch.equal(v0, v1)
                print(f"probe tree0 vs tree{i} ({key}): V' "
                      f"{'bitwise equal' if same else 'differs'}"
                      f" (max |diff| {dv:.3e}); traces max |diff| {dt:.3e} "
                      f"(largest |t| {float(t0.abs().max()):.3e})",
                      flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
