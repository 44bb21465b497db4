"""K2: R = alpha * I + beta * X^T X as a hand-written CUDA kernel.

Counterpart of ``repro/kernels/gram.py``: the residual I - X^T X of every
grid-tier Newton-Schulz iteration.  The product is symmetric, so the
kernel (``csrc/gram_upper.cu``) computes only the nb(nb+1)/2 upper output
tiles and each off-diagonal tile also writes its transpose: the result is
the full symmetric matrix, with no separate mirror pass.  alpha * I is
added in fp32 on diagonal tiles before the one rounding.  ``plain`` is the
plain PyTorch version of the same function.  The GEMM core, its variants
and its shared memory are K1's (``matmul_add.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul_add import TILE, aligned, smem_bytes

plain = ref.gram

_SYMBOL = "prism_gram_upper"
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + \
    [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

# launches of the element-by-element instantiation (see matmul_add.py)
unaligned_launches = 0


def upper_tiles(n: int) -> int:
    """Blocks of one slice's grid: the nb(nb+1)/2 upper output tiles."""
    nb = -(-n // TILE)
    return nb * (nb + 1) // 2


def unrank(t: int, n: int):
    """The (row tile, column tile) block t computes, as the kernel unranks
    it: row-major over the upper triangle."""
    nb = -(-n // TILE)
    bi = 0
    while t >= nb - bi:
        t -= nb - bi
        bi += 1
    return bi, bi + t


def gram_upper(X: torch.Tensor, *, alpha: float = 1.0,
               beta: float = -1.0) -> torch.Tensor:
    """Launch K2 on a contiguous CUDA tensor X [Bt, m, n] (fp32 or bf16);
    returns the full symmetric R [Bt, n, n] in X's dtype."""
    _build.check_cuda_operands("gram_upper", (X,))
    nb, m, n = X.shape
    R = torch.empty((nb, n, n), dtype=X.dtype, device=X.device)
    if R.numel() == 0:
        return R
    global unaligned_launches
    fast = aligned(X, R)
    lib = _build.library("gram_upper", _SYMBOL, _ARGTYPES)
    with torch.cuda.device(X.device):
        _build.launch("gram_upper", lib, _SYMBOL, X.data_ptr(),
                      R.data_ptr(), nb, m, n, upper_tiles(n), float(alpha),
                      float(beta), int(X.dtype == torch.bfloat16), int(fast),
                      smem_bytes(), _build.stream_handle(X))
    unaligned_launches += not fast
    return R
