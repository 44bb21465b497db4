"""Build, load and launch the hand-written CUDA kernels.

Each source in ``csrc/`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds instead of minutes.  All missing
libraries build in parallel, one ``nvcc`` per source, at the first kernel
call (or an explicit ``build()``), never on import: importing the package
needs neither ``nvcc`` nor a GPU.  Libraries land in ``build/kernels/``
at the root of the checkout (git-ignored), named by a hash of their
sources and flags, so an edited source rebuilds and an unchanged one is
reused.

``LAUNCHES`` counts, per kernel, the launches that succeeded: a wrapper
adds one where it launches its kernel and nowhere else (``ops.py`` reads
and resets the counts).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("matmul_add", "gram_upper", "warm_tail", "sketch_step",
           "sketch_chain", "residual_chain", "apply_g")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# the compiler's report of each source built with ``verbose``
LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels build only where the CUDA toolkit "
                           "is installed")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False
          ) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all at
    once.  Returns the wall seconds per compiled source (empty when all
    were cached).  ``verbose`` adds ``-Xptxas=-v`` and prints what the
    compiler reports (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {n}.cu\n{log}", flush=True)
            LOGS[n] = log
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str, symbol: str, argtypes: Sequence) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), with
    the launcher ``symbol`` typed as ``argtypes`` -> int status."""
    with _LOCK:
        if name not in _LIBS:
            build(KERNELS)
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            lib.prism_error_string.argtypes = [ctypes.c_int]
            lib.prism_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def launch(name: str, lib: ctypes.CDLL, symbol: str, *args) -> None:
    """Call a launcher, raise on the CUDA status it returns, count it."""
    code = getattr(lib, symbol)(*args)
    if code != 0:
        msg = lib.prism_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
    LAUNCHES[name] += 1


def stream_handle(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operands(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """Raise unless every operand is a contiguous fp32/bf16 CUDA tensor of
    rank 3, all on one device with one dtype."""
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: operands must be CUDA tensors, got "
                             f"{t.device}")
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: operands must share one device and "
                             f"dtype, got {t.device}/{t.dtype} and "
                             f"{first.device}/{first.dtype}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: dtype must be float32 or bfloat16, "
                             f"got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name}: operands must have rank 3, got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_companion(name: str, like: torch.Tensor, t: torch.Tensor) -> None:
    """Raise unless ``t`` (an operand of any rank, e.g. the sketch) is a
    contiguous CUDA tensor on ``like``'s device with ``like``'s dtype."""
    if not t.is_cuda or t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: operands must be CUDA tensors on one "
                         f"device with one dtype, got {t.device}/{t.dtype} "
                         f"and {like.device}/{like.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")
