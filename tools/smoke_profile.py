#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s clock goes outside the kernels: cProfile of
chosen phases, in this process and in rank 0 of each world phase, and the
host's rates that bound them.  Run from the root of a checkout, on a
machine with a CUDA card and nvcc:

    python3 tools/smoke_profile.py [PHASE ...]    (default: 13 14 15 16 17)
    python3 tools/smoke_profile.py --host

A phase's profile (the 70 largest cumulative times, then the 40 largest
own times) goes to ``chiprun_out/profile_<N>.txt``, and for phases 14-17
rank 0's to ``chiprun_out/profile_<N>_rank0.txt``; each phase's seconds
are printed.  The phases run as ``chip_smoke.main`` runs them, bytecode
cache included (``chip_smoke.bytecode_cache``).  ``--host`` prints
whether the interpreter writes bytecode, the seconds of ``import torch``
in a fresh process as the interpreter runs, writing the cache and
reading it, zlib.crc32's rate on one
thread and on 2-8 (``checkpoint._crc`` takes a large leaf a chunk a
thread), and the rates of allocating page-locked host memory and of a
device-to-host copy into pageable memory.
"""
from __future__ import annotations

import cProfile
import io
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke  # noqa: E402  (the ranks import it here too)

RANK_BODIES = {"14": "_p14_rank_body", "15": "_p15_rank_body",
               "16": "_p16_rank_body", "17": "_p17_rank_body"}


def dump(prof: cProfile.Profile, name: str) -> None:
    OUT.mkdir(exist_ok=True)
    text = io.StringIO()
    st = pstats.Stats(prof, stream=text)
    st.sort_stats("cumulative").print_stats(70)
    st.sort_stats("tottime").print_stats(40)
    (OUT / f"profile_{name}.txt").write_text(text.getvalue())


def profiled_rank(phase: str, body):
    """``body`` (a rank's work), profiled on rank 0."""
    def run(rank, *args, **kw):
        if rank != 0:
            return body(rank, *args, **kw)
        prof = cProfile.Profile()
        prof.enable()
        try:
            return body(rank, *args, **kw)
        finally:
            prof.disable()
            dump(prof, f"{phase}_rank0")
    return run


# module level: the spawned ranks run this file as their main module
for _phase, _name in RANK_BODIES.items():
    setattr(chip_smoke, _name,
            profiled_rank(_phase, getattr(chip_smoke, _name)))


def rate(nbytes: int, fn) -> float:
    t0 = time.perf_counter()
    fn()
    return nbytes / (time.perf_counter() - t0) / 1e9


def host() -> None:
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    print(f"dont_write_bytecode {sys.flags.dont_write_bytecode}, "
          f"PYTHONDONTWRITEBYTECODE "
          f"{os.environ.get('PYTHONDONTWRITEBYTECODE')!r}, torch's "
          f"__pycache__ present "
          f"{(Path(torch.__file__).parent / '__pycache__').is_dir()}")
    cache = {"PYTHONPYCACHEPREFIX": str(ROOT / "build" / "pycache")}
    for label, env in (("as the interpreter runs", {}),
                       ("writing the cache", dict(cache,
                                                  PYTHONDONTWRITEBYTECODE="")),
                       ("reading the cache", cache)):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import torch"], check=True,
                       env=dict(os.environ, **env))
        print(f"import torch in a fresh process, {label}: "
              f"{time.perf_counter() - t0:.2f} s")
    buf = np.random.default_rng(0).integers(0, 256, 1 << 28, dtype=np.uint8)
    print(f"zlib.crc32 one thread: {rate(buf.size, lambda: zlib.crc32(buf)):.2f}"
          f" GB/s")
    chunks = np.array_split(buf, 32)
    for n in (2, 4, 8):
        with ThreadPoolExecutor(n) as ex:
            r = rate(buf.size, lambda: list(ex.map(zlib.crc32, chunks)))
        print(f"zlib.crc32 {n} threads: {r:.2f} GB/s")
    r = rate(buf.size, lambda: torch.empty(buf.size, dtype=torch.uint8,
                                           pin_memory=True))
    print(f"page-locked allocation: {r:.2f} GB/s")
    x = torch.empty(buf.size, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    print(f"device to pageable host: {rate(buf.size, x.cpu):.2f} GB/s")


def main() -> None:
    if "--host" in sys.argv[1:]:
        host()
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", chip_smoke.ALLOC_CONF)
    chip_smoke.bytecode_cache()
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    _build.build()
    for phase in sys.argv[1:] or ["13", "14", "15", "16", "17"]:
        t0 = time.perf_counter()
        prof = cProfile.Profile()
        prof.enable()
        getattr(chip_smoke, f"phase{phase}")(torch)
        prof.disable()
        dump(prof, phase)
        print(f"phase {phase} in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
