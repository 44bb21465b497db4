#!/usr/bin/env python3
"""The model axis on the card alone.  First a probe of the collectives the
port's tensor parallelism and ZeRO-3 run on: four ranks that share the
card on gloo (NCCL refuses two ranks on one device) run ``all_reduce``,
``all_gather`` and ``reduce_scatter`` on CUDA tensors over the world and
over the (data, model) mesh's subgroups (``new_group``), at 4 MB and
250 MB a rank, check each result and time it (host clock around the call
and a synchronize, the median of PROBE_REPS).  An op the backend refuses
is printed with its error.  Then ``chip_smoke.py``'s phase 15 and nothing
else: gpt2-paper at full width trained by four ranks on a (2, 2) mesh
under "tp" and resumed under "zero" with Muon's local reshard
(``chip_smoke.phase15``; the module docstring lists its gates).  Run from
the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/tp_probe.py [--no-phase]
"""
from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]  # the spawned ranks too
PROBE_WORLD = 4
PROBE_MESH = (2, 2)
PROBE_MB = (4, 250)
PROBE_REPS = 3
PROBE_TIMEOUT_S = 300


def _timed(torch, fn):
    times = []
    for _ in range(PROBE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _probe_rank(rank, world, store):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh

    lmesh.init_world(rank, world, f"file://{store}", device="cuda",
                     timeout_s=PROBE_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        mesh = lmesh.make_debug_mesh(*PROBE_MESH)
        groups_ms = (time.perf_counter() - t0) * 1e3
        groups = {"world": (dist.group.WORLD, world),
                  "data": (mesh.group(("data",)), PROBE_MESH[0]),
                  "model": (mesh.group(("model",)), PROBE_MESH[1])}
        rows = []
        for mb in PROBE_MB:
            n = mb * 2**20 // 4
            for gname, (g, size) in groups.items():
                me = dist.get_rank(g)
                x = torch.full((n,), float(me + 1), device="cuda")

                def reduce():
                    y = x.clone()
                    dist.all_reduce(y, group=g)
                    return y
                ms, y = _timed(torch, reduce)
                ok = bool((y == size * (size + 1) / 2).all())
                rows.append(("all_reduce", gname, mb, ms, ok, ""))

                def gather():
                    parts = [torch.empty_like(x) for _ in range(size)]
                    dist.all_gather(parts, x, group=g)
                    return torch.stack([p[0] for p in parts])
                ms, y = _timed(torch, gather)
                ok = y.tolist() == [float(i + 1) for i in range(size)]
                rows.append(("all_gather", gname, mb, ms, ok, ""))

                def scatter():
                    out = torch.empty(n // size, device="cuda")
                    dist.reduce_scatter(out, list(x.chunk(size)), group=g)
                    return out
                try:
                    ms, y = _timed(torch, scatter)
                    ok = bool((y == size * (size + 1) / 2).all())
                    rows.append(("reduce_scatter", gname, mb, ms, ok, ""))
                except Exception as e:  # the backend's refusal is a result
                    msg = str(e).splitlines()[0] if str(e) else ""
                    rows.append(("reduce_scatter", gname, mb, None, False,
                                 f"{type(e).__name__}: {msg[:120]}"))
        if rank == 0:
            print(f"probe: subgroups built in {groups_ms:.1f} ms "
                  f"(new_group over every axis subset)", flush=True)
            for op, gname, mb, ms, ok, err in rows:
                t = "refused" if ms is None else f"{ms:.2f} ms"
                rate = "" if ms is None else \
                    f", {mb / 1024 / (ms / 1e3):.2f} GB/s a rank"
                print(f"probe: {op:14s} {gname:5s} {mb:4d} MB a rank: {t}"
                      f"{rate}; correct {ok} {err}", flush=True)
        dist.barrier()
    finally:
        lmesh.close_world()


def main() -> None:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import chip_smoke

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", chip_smoke.ALLOC_CONF)
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        chip_smoke.fail("tp_probe needs a CUDA device")
    card = chip_smoke._card_line()
    chip_smoke.log(f"card: {card}; torch {torch.__version__}, CUDA "
                   f"{torch.version.cuda}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(_probe_rank, args=(PROBE_WORLD,
                                              os.path.join(tmp, "store")),
                           nprocs=PROBE_WORLD, start_method="spawn")
        chip_smoke.log(f"probe done in {time.perf_counter() - t0:.1f} s "
                       f"({card})")
    if "--no-phase" in sys.argv:
        return
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = chip_smoke.phase15(torch)
    chip_smoke.log(f"phase 15 done in {time.perf_counter() - t0:.1f} s; "
                   f"rank 0's launches {counts}")
    chip_smoke.log(f"card: {card}")


if __name__ == "__main__":
    main()
