"""K3: a whole constant-alpha warm tail in one CUDA launch (polar family).

Counterpart of ``repro/kernels/fused_iter.py::warm_tail`` (DESIGN.md §10):
an entire run of constant-alpha Newton-Schulz iterations — the warm-start
phase of PRISM, or a whole classical chain — as ONE launch.  One block per
batch slice loops over the iterations with X, R, the rounded Horner
operand and the fp32 Horner accumulator in shared memory
(``csrc/warm_tail.cu``), so device memory sees one read and one write of
X for the whole run.  The alphas come from a small device array, one per
iteration.  Its accumulation order is the fused one (``ref._horner``):
the f_j * X epilogues stay fp32 and only each product's operand rounds —
not the grid tier's order, which rounds after every GEMM.

``smem_bytes`` is the kernel's shared-memory footprint, the model
``ops.fused_fits`` chooses the tier with.  The residual-plus-sketch-chain
and Horner-application kernels of the fitted iterations (K6, K7) are
ported with slice 2 (ROADMAP.md Queue 1 item 2).  ``plain`` is the plain
PyTorch version of the same function.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build, ref

plain = ref.warm_tail

#: most shared memory one block may use on the H100 (opt-in maximum)
MAX_SMEM_BYTES = 232_448
MAX_DEGREE = 4

_SYMBOL = "prism_warm_tail"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
    [ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
     ctypes.c_void_p]


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def smem_bytes(m: int, n: int, itemsize: int) -> int:
    """Shared memory one K3 block needs for an [m, n] slice: X and the
    rounded Horner operand ([m, n] each), R ([n, n]), all in the operand
    dtype and 16-byte aligned, plus the fp32 Horner accumulator."""
    return 2 * _align16(m * n * itemsize) + _align16(n * n * itemsize) + \
        4 * m * n


def warm_tail(X: torch.Tensor, alphas: Sequence[float], *,
              coeffs: Sequence[float]) -> torch.Tensor:
    """Launch K3 on a contiguous CUDA tensor X [Bt, m, n] (fp32 or bf16):
    ``len(alphas)`` polar iterations, one launch.  ``coeffs`` are the
    ascending Taylor coefficients f_0..f_{d-1} of g_d."""
    _build.check_cuda_operands("warm_tail", (X,))
    nb, m, n = X.shape
    degree = len(coeffs)
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"warm_tail: degree {degree} outside "
                         f"1..{MAX_DEGREE}")
    smem = smem_bytes(m, n, X.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"warm_tail: an [{m}, {n}] {X.dtype} slice needs "
                         f"{smem} bytes of shared memory, more than the "
                         f"{MAX_SMEM_BYTES} a block has; use the grid tier")
    out = torch.empty_like(X)
    if out.numel() == 0 or not alphas:
        return out.copy_(X)
    a = torch.tensor([float(v) for v in alphas], dtype=torch.float32,
                     device=X.device)
    c = (ctypes.c_float * degree)(*[float(v) for v in coeffs])
    lib = _build.library("warm_tail", _SYMBOL, _ARGTYPES)
    with torch.cuda.device(X.device):
        _build.launch("warm_tail", lib, _SYMBOL, X.data_ptr(),
                      out.data_ptr(), a.data_ptr(), len(alphas), nb, m, n,
                      degree, c, smem, int(X.dtype == torch.bfloat16),
                      _build.stream_handle(X))
    return out
