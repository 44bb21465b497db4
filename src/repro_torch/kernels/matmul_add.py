"""K1: D = alpha * A @ B + beta * C as a hand-written CUDA kernel.

Counterpart of ``repro/kernels/matmul_add.py``: the workhorse of the
grid-tier Newton-Schulz chains, where every polynomial update
X (f0 I + f1 R + ... + a R^d) runs as d fused GEMMs (Horner on R), and the
``+ beta * C`` epilogue saves a read-modify-write of the [m, n] result per
Horner step.  The kernel (``csrc/matmul_add.cu``) keeps an fp32 register
accumulator over the contraction, reads C only in the epilogue and rounds
once; the grid carries the batch, so a [B, m, n] bucket is one launch
(DESIGN.md §7).  ``plain`` is the plain PyTorch version of the same
function.

K1 and K2 (``gram.py``) share one GEMM core (``csrc/gemm.cuh``), with two
instantiations of each kernel: the aligned one copies 16-byte chunks
into its shared-memory ring, the other loads element by element.
``aligned`` chooses between them; ``smem_bytes`` mirrors ``gemm.cuh``'s
footprint, and the launchers refuse any other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

plain = ref.matmul_add

_SYMBOL = "prism_matmul_add"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
    [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

TILE = 128          # output tile of one block (gemm.cuh)
STAGES = 4          # slots of the ring
STAGE_K_BYTES = 64  # bytes of the contraction per operand row and stage

# launches of the element-by-element instantiation (the main paths take
# none: chip_smoke.py reads this beside the launch counts)
unaligned_launches = 0


def smem_bytes() -> int:
    """Dynamic shared memory of one K1/K2 block, in either dtype: the ring
    (both operands' [128, 64-byte] stage tiles in each slot) or the fp32
    128 x 128 output tile staged after the loop, whichever is larger."""
    ring = STAGES * 2 * TILE * STAGE_K_BYTES
    return max(ring, TILE * TILE * 4)


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether K1/K2 may take their aligned instantiation for these
    operands: every row holds a whole number of 16-byte chunks and every
    operand starts on 16 bytes (so does each slice of a contiguous
    batch)."""
    for t in tensors:
        if t is None:
            continue
        if (t.shape[-1] * t.element_size()) % 16 or t.data_ptr() % 16:
            return False
    return True


def matmul_add(A: torch.Tensor, B: torch.Tensor,
               C: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
               beta: float = 0.0) -> torch.Tensor:
    """Launch K1 on CUDA tensors A [Bt, m, k], B [Bt, k, n], C [Bt, m, n].

    Operands are contiguous, of one dtype (fp32 or bf16); the result has
    A's dtype.  C is read only when given and ``beta != 0``.
    """
    ops = (A, B) if C is None else (A, B, C)
    _build.check_cuda_operands("matmul_add", ops)
    nb, m, k = A.shape
    if B.shape[0] != nb or B.shape[1] != k:
        raise ValueError(f"matmul_add: A {tuple(A.shape)} and B "
                         f"{tuple(B.shape)} do not chain")
    n = B.shape[2]
    if C is not None and tuple(C.shape) != (nb, m, n):
        raise ValueError(f"matmul_add: C {tuple(C.shape)} is not "
                         f"{(nb, m, n)}")
    D = torch.empty((nb, m, n), dtype=A.dtype, device=A.device)
    if D.numel() == 0:
        return D
    global unaligned_launches
    has_c = C is not None and beta != 0.0
    fast = aligned(A, B, C if has_c else None, D)
    lib = _build.library("matmul_add", _SYMBOL, _ARGTYPES)
    with torch.cuda.device(A.device):
        _build.launch("matmul_add", lib, _SYMBOL, A.data_ptr(),
                      B.data_ptr(), C.data_ptr() if has_c else None,
                      D.data_ptr(), nb, m, n, k, float(alpha), float(beta),
                      int(has_c), int(A.dtype == torch.bfloat16), int(fast),
                      smem_bytes(), _build.stream_handle(A))
    unaligned_launches += not fast
    return D
