#!/usr/bin/env python3
"""Time K5 ``sketch_chain`` of a source tree at the main paths' shapes
beside its plain version, for the checkout's design and for named
variants of it, on a CUDA card.

For each name in ``--change`` (``as_is`` is the checkout unchanged) the
script copies ``<tree>/src`` into ``build/probe/<name>/`` (git-ignored),
applies the variant there, builds that copy's K5 with ``-Xptxas -v``
(registers, stack and spills are printed) and, in its own process, prints
what the launch would run with (cluster size, clusters resident at once,
registers, local bytes), times K5 and the plain chain with CUDA events
(median of 20 launches after 3 warm-up launches; K5 also as the median
of 20 runs of 10 launches back to back, the device's time without the
host's launch time) at [40, 1024, 1024] x 6,
[20, 1024, 1024] x 6 and [100, 1024, 1024] x 10 (p = 8, fp32, or bf16 with
``--dtype``; ``--shapes B,POWERS ...`` for others), with R's streamed rate,
and the median SM clock and board power that ``nvidia-smi`` sampled while
K5 ran back to back for half a second at [40, 1024, 1024] x 6.  Run from
the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/chain_probe.py [--tree DIR] [--dtype float32|bfloat16]
        [--shapes B,POWERS ...] [--change NAME[+NAME...] ...]

A name joined from several with ``+`` applies them all.
``--tree`` defaults to this checkout; point it at an unpacked ``git
archive`` of another commit to time that commit's K5 in the same call.
The variants in ``TIMING_ONLY`` leave a phase out and give wrong traces:
they only time what is left.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "csrc/sketch_chain.cu"
PY = "sketch_traces.py"


def _const(name_cu, name_py, old, new):
    """One constant of K5's layout, in the kernel and in its mirror."""
    edits = [(CU, f"constexpr int {name_cu} = {old};",
              f"constexpr int {name_cu} = {new};")]
    if name_py:
        edits.append((PY, f"{name_py} = {old}", f"{name_py} = {new}"))
    return edits


# name -> [(file under src/repro_torch/kernels, text, replacement), ...]
CHANGES = {
    # blocks a slice
    "cluster4": _const("CLUSTER", "CHAIN_CLUSTER", 16, 4),
    "cluster8": _const("CLUSTER", "CHAIN_CLUSTER", 16, 8),
    # R's ring: 1 slot (each step waits for its own loads), 3 or 4
    "stages1": _const("STAGES", "CHAIN_STAGES", 2, 1),
    "stages3": _const("STAGES", "CHAIN_STAGES", 2, 3),
    "stages4": _const("STAGES", "CHAIN_STAGES", 2, 4),
    # 4 rows a warp at p <= 8 (32 sums a lane, one after the reduce-scatter)
    "rows4": _const("GROUP_SUMS", "CHAIN_GROUP_SUMS", 64, 32),
    # 512 threads a block (with 4 rows a warp: 8 take too many registers)
    "threads512": (_const("THREADS", "CHAIN_THREADS", 256, 512)
                   + _const("GROUP_SUMS", "CHAIN_GROUP_SUMS", 64, 32)),
    # two blocks an SM: 4 rows a warp (100 KB a block in fp32) and at most
    # 128 registers a thread
    "two_blocks_an_sm": (_const("MIN_BLOCKS", None, 1, 2)
                         + _const("GROUP_SUMS", "CHAIN_GROUP_SUMS", 64, 32)),
    # R's copies marked to stay in L2 (evict_last) rather than the default
    "evict_last": [(
        "csrc/chain.cuh",
        'asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"',
        'asm volatile("{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::'
        'evict_last.b64 pol, 1.0;\\ncp.async.cg.shared.global.L2::cache_hint'
        ' [%0], [%1], 16, %2, pol;\\n}\\n"')],
}
TIMING_ONLY = {
    # no V_i stored into the ranks' buffers (distributed shared memory)
    "no_push": [(CU, "const bool push = pw + 1 < max_power;",
                 "const bool push = false;")],
    # the cluster barrier between powers a block barrier only (the last
    # power keeps it: no block may leave while others store into it)
    "no_cluster_barrier": [(
        CU, "    cluster.sync();\n    if (rank == 0 && tid == 0) {",
        "    if (push) __syncthreads(); else cluster.sync();\n"
        "    if (rank == 0 && tid == 0) {")],
    # no byte of R read: the copies zero-fill the ring
    "no_loads": [(CU, "        const bool ok = j < lrows && kok;",
                  "        const bool ok = false;")],
    # the ring read without waiting for its copies
    "no_wait": [(CU, "        ring_wait<STAGES - 1>();\n", "")],
    # R streamed into the ring but never read: no FMA
    "loads_only": [(CU, "        if (k < n) {\n          float r[ROWS][VEC];",
                    "        if (k < 0) {\n          float r[ROWS][VEC];")],
}

PROBE = r"""
import contextlib, io, re, statistics, subprocess, sys, time
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import _build, sketch_traces

dtype = getattr(torch, sys.argv[1])
item = torch.empty((), dtype=dtype).element_size()
_build.KERNELS = ("sketch_chain",)
with contextlib.redirect_stdout(io.StringIO()):  # the summary below
    _build.build(("sketch_chain",), verbose=True)
for entry in _build.LOGS.get("sketch_chain", "").split(
        "Compiling entry function")[1:]:
    kernel = re.search(r"sketch_chain_kernelI(\w+?)Li(\d+)ELi(\d+)E", entry)
    regs = re.search(r"Used (\d+) registers", entry)
    stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      entry)
    if kernel and regs and stack:
        print(f"probe ptxas {kernel.group(1)[-8:]} vec {kernel.group(2)} "
              f"tile {kernel.group(3)}: {regs.group(1)} registers, stack "
              f"{stack.group(1)} B, spill stores {stack.group(2)} B",
              flush=True)


def ms(fn, reps=20, warmup=3, batch=1):
    # median over reps of the time of `batch` launches back to back, per
    # launch; batch = 1 is chip_smoke.py's timing (it includes the host's
    # launch time), a batch of 10 the device's
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
gen.manual_seed(6)
n, p = 1024, 8
st = (torch.randn((n, p), generator=gen, device="cuda") * p ** -0.5).to(dtype)
for nb, powers in [tuple(map(int, a.split(","))) for a in sys.argv[2:]]:
    q, _ = torch.linalg.qr(torch.randn((nb, n, n), generator=gen,
                                       device="cuda"))
    d = 0.95 * torch.sign(torch.randn((nb, 1, n), generator=gen,
                                      device="cuda"))
    r = ((q * d) @ q.transpose(-1, -2)).to(dtype)
    del q
    info = sketch_traces.chain_launch_info(r, st)
    k = ms(lambda: sketch_traces.sketch_chain(r, st, powers))
    k10 = ms(lambda: sketch_traces.sketch_chain(r, st, powers), batch=10)
    plain = ms(lambda: sketch_traces.plain_chain(r, st, powers))
    err = float((sketch_traces.sketch_chain(r, st, powers)
                 - sketch_traces.plain_chain(r, st, powers)).abs().max())
    streamed = item * nb * powers * n * n
    print(f"probe sketch_chain ({nb}, {n}, {n}) x {powers} {sys.argv[1]}: "
          f"kernel {k:.4f} ms (back to back {k10:.4f} ms) plain {plain:.4f} "
          f"ms; max |err| {err:.3e}; {streamed / k10 / 1e6:.1f} GB/s of R "
          f"back to back; cluster {info['cluster']}, "
          f"{info['active_clusters']} clusters resident, "
          f"{info['registers']} registers, {info['local_bytes']} B local, "
          f"{info['smem_bytes']} B shared", flush=True)
    if (nb, powers) == (40, 6):
        mhz, watt = clocks(lambda: sketch_traces.sketch_chain(r, st, powers))
        print(f"probe sketch_chain ({nb}, {n}, {n}) x {powers}: sm clock "
              f"{mhz:.0f} MHz, power {watt:.0f} W", flush=True)
    del r
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--shapes", nargs="+", default=["40,6", "20,6", "100,10"])
    ap.add_argument("--change", nargs="+", default=["as_is"])
    args = ap.parse_args()
    edits = {**CHANGES, **TIMING_ONLY}
    for change in args.change:
        for part in change.split("+"):
            if part != "as_is" and part not in edits:
                raise SystemExit(f"unknown change {part}: one of "
                                 f"{sorted(edits)} or as_is")
    code = 0
    for change in args.change:
        name = f"{args.tree.resolve().name}-{change}"
        d = ROOT / "build" / "probe" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(args.tree / "src", d / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        parts = change.split("+")
        timing_only = bool(set(parts) & set(TIMING_ONLY))
        for source, text, replacement in [e for part in parts
                                          for e in edits.get(part, [])]:
            f = d / "src" / "repro_torch" / "kernels" / source
            src = f.read_text()
            if text not in src:
                raise SystemExit(f"{change}: the text to change is not in "
                                 f"{source}")
            f.write_text(src.replace(text, replacement))
        print(f"probe tree {args.tree} change {change}"
              f"{' (timing only: wrong traces)' if timing_only else ''}",
              flush=True)
        r = subprocess.run([sys.executable, "-c", PROBE, args.dtype,
                            *args.shapes], cwd=d, timeout=900)
        code = code or r.returncode
    sys.exit(code)


if __name__ == "__main__":
    main()
