"""K3 ``warm_tail``, K6 ``residual_chain`` and K7 ``apply_g``: the fused
tier's single-launch kernels, polar family.

Counterpart of ``repro/kernels/fused_iter.py`` (DESIGN.md §10).  Each
kernel runs one block per batch slice and keeps the slice's whole working
set in that block's shared memory:

  * ``warm_tail`` (K3, ``csrc/warm_tail.cu``): an entire run of
    constant-alpha Newton-Schulz iterations (the warm phase of PRISM, or a
    whole classical chain) as ONE launch, with X, R, the rounded Horner
    operand and the fp32 Horner accumulator in shared memory; the alphas
    come from a small device array, one per iteration.
  * ``residual_chain`` (K6, ``csrc/residual_chain.cu``): the first launch
    of a fitted iteration — R = I - X^T X formed on an fp32 accumulator,
    rounded once, written out, and the whole sketched power chain run on
    the rounded R in shared memory, each trace reduced from the fp32
    accumulator before V rounds.
  * ``apply_g`` (K7, ``csrc/apply_g.cu``): the second launch — the d Horner
    GEMMs of X g_d(R; alpha) on an fp32 accumulator, with the FITTED fp32
    alpha read per slice from a device tensor (never rounded, never read
    back to the host).

Their accumulation order is the fused one (``ref._horner``): the f_j * X
epilogues stay fp32 and only each product's operand rounds.  The
``*_smem_bytes`` functions are the kernels' shared-memory layouts, which
``ops.fused_fits`` chooses the tier with and each launcher re-checks.
The sign and coupled sqrt families come with Shampoo (ROADMAP.md Queue 1
item 6).  ``plain`` (K3), ``plain_residual_chain`` and ``plain_apply_g``
are the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref

plain = ref.warm_tail
plain_residual_chain = ref.residual_chain
plain_apply_g = ref.apply_g

#: most shared memory one block may use on the H100 (opt-in maximum)
MAX_SMEM_BYTES = 232_448
MAX_DEGREE = 4
MAX_SKETCH = 16
THREADS = 256     # threads of a K3/K6/K7 block (csrc/*.cu)

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


def residual_chain_smem_bytes(m: int, n: int, p: int, itemsize: int) -> int:
    """Shared memory one K6 block needs: X [m, n], R [n, n] and St plus the
    two V buffers ([p, n] each), all in the operand dtype and 16-byte
    aligned, plus one fp32 trace partial per thread."""
    return _align16(m * n * itemsize) + _align16(n * n * itemsize) + \
        3 * _align16(p * n * itemsize) + 4 * THREADS


def apply_g_smem_bytes(m: int, n: int, itemsize: int) -> int:
    """Shared memory one K7 block needs: the K3 layout (X, the rounded
    Horner operand, R and the fp32 accumulator)."""
    return smem_bytes(m, n, itemsize)


def _check_smem(name: str, need: int, m: int, n: int, dtype) -> None:
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: an [{m}, {n}] {dtype} slice needs "
                         f"{need} bytes of shared memory, more than the "
                         f"{MAX_SMEM_BYTES} a block has; use the grid tier")


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
    _check_smem("warm_tail", smem, m, n, X.dtype)
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


_RC_SYMBOL = "prism_residual_chain"
_RC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
    [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def residual_chain(X: torch.Tensor, St: torch.Tensor, max_power: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on a contiguous CUDA X [Bt, m, n] and St [n, p] (one
    dtype): (R [Bt, n, n] in X's dtype, fp32 traces [Bt, max_power] of
    powers 1..max_power), one launch."""
    _build.check_cuda_operands("residual_chain", (X,))
    nb, m, n = X.shape
    _build.check_companion("residual_chain", X, St)
    if St.dim() != 2 or St.shape[0] != n or \
            not 1 <= St.shape[1] <= MAX_SKETCH:
        raise ValueError(f"residual_chain: St must be [{n}, p] with p in "
                         f"1..{MAX_SKETCH}, got {tuple(St.shape)}")
    p = St.shape[1]
    smem = residual_chain_smem_bytes(m, n, p, X.element_size())
    _check_smem("residual_chain", smem, m, n, X.dtype)
    R = torch.empty((nb, n, n), dtype=X.dtype, device=X.device)
    t = torch.empty((nb, max_power), dtype=torch.float32, device=X.device)
    if R.numel() == 0:
        return R, t.zero_()
    lib = _build.library("residual_chain", _RC_SYMBOL, _RC_ARGTYPES)
    with torch.cuda.device(X.device):
        _build.launch("residual_chain", lib, _RC_SYMBOL, X.data_ptr(),
                      St.data_ptr(), R.data_ptr(), t.data_ptr(), nb, m, n,
                      p, max_power, smem, int(X.dtype == torch.bfloat16),
                      _build.stream_handle(X))
    return R, t


_AG_SYMBOL = "prism_apply_g"
_AG_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
    [ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
     ctypes.c_void_p]


def apply_g(X: torch.Tensor, R: torch.Tensor, alpha: torch.Tensor, *,
            coeffs: Sequence[float]) -> torch.Tensor:
    """Launch K7 on contiguous CUDA X [Bt, m, n], R [Bt, n, n] (one dtype)
    and alpha [Bt] fp32 on the same device: X g_d(R; alpha) with alpha
    read per slice on the device, one launch.  ``coeffs`` are the
    ascending Taylor coefficients f_0..f_{d-1} of g_d."""
    _build.check_cuda_operands("apply_g", (X, R))
    nb, m, n = X.shape
    if tuple(R.shape) != (nb, n, n):
        raise ValueError(f"apply_g: R {tuple(R.shape)} is not {(nb, n, n)}")
    if not (torch.is_tensor(alpha) and alpha.dtype == torch.float32
            and alpha.device == X.device and tuple(alpha.shape) == (nb,)
            and alpha.is_contiguous()):
        raise ValueError(f"apply_g: alpha must be a contiguous fp32 [{nb}] "
                         f"tensor on {X.device}")
    degree = len(coeffs)
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"apply_g: degree {degree} outside "
                         f"1..{MAX_DEGREE}")
    smem = apply_g_smem_bytes(m, n, X.element_size())
    _check_smem("apply_g", smem, m, n, X.dtype)
    out = torch.empty_like(X)
    if out.numel() == 0:
        return out
    c = (ctypes.c_float * degree)(*[float(v) for v in coeffs])
    lib = _build.library("apply_g", _AG_SYMBOL, _AG_ARGTYPES)
    with torch.cuda.device(X.device):
        _build.launch("apply_g", lib, _AG_SYMBOL, X.data_ptr(),
                      R.data_ptr(), alpha.data_ptr(), out.data_ptr(), nb, m,
                      n, degree, c, smem, int(X.dtype == torch.bfloat16),
                      _build.stream_handle(X))
    return out
