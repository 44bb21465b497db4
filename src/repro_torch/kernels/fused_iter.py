"""K3 ``warm_tail``, K6 ``residual_chain`` and K7 ``apply_g``: the fused
tier's single-launch kernels, for the polar, sign and coupled sqrt
families.

Counterpart of ``repro/kernels/fused_iter.py`` (DESIGN.md §10).  Each
kernel keeps the slice's working set in shared memory, one block per batch
slice (K7: a few blocks a slice, each with its share):

  * ``warm_tail`` (K3, ``csrc/warm_tail.cu``): an entire run of
    constant-alpha Newton-Schulz iterations (the warm phase of PRISM, or a
    whole classical chain) as ONE launch, with X (and the coupled Y), R,
    the rounded Horner operand and the fp32 Horner accumulator in shared
    memory; the alphas, one per iteration, are kernel arguments passed by
    value (at most ``MAX_WARM_ITERS``), so nothing is copied to the device
    first.
  * ``residual_chain`` (K6, ``csrc/residual_chain.cu``): the first launch
    of a fitted iteration — the family residual (I - X^T X, I - X X, or
    sym(I - Y X)) formed on an fp32 accumulator, rounded once, written
    out, and the whole sketched power chain run on the rounded R in shared
    memory, each trace reduced from the fp32 accumulator before V rounds.
  * ``apply_g`` (K7, ``csrc/apply_g.cu``): the second launch — the d Horner
    GEMMs of X g_d(R; alpha) (and, coupled, g_d(R; alpha) Y, in the same
    launch) on an fp32 accumulator, with the FITTED fp32 alpha read per
    slice from a device tensor (never rounded, never read back to the
    host).  Its grid is (batch, splits x sides): a block takes
    ``apply_g_rows`` rows of X or, coupled, as many columns of Y, so that
    a launch spreads over the SMs.

K6 and K7 register-tile their products (``csrc/tiles.cuh``) over shared
operands with the row pitch ``tile_pitch``.  Their accumulation order is
the fused one (``ref._horner``): the f_j * X epilogues stay fp32 and only
each product's operand rounds.  The ``*_smem_bytes`` functions are the
kernels' shared-memory layouts, which ``ops.fused_fits`` chooses the tier
with and each launcher re-checks.  ``plain`` (K3),
``plain_residual_chain`` and ``plain_apply_g`` are the plain PyTorch
versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref

plain = ref.warm_tail
plain_residual_chain = ref.residual_chain
plain_apply_g = ref.apply_g

#: most shared memory one block may use on the H100 (opt-in maximum)
MAX_SMEM_BYTES = 232_448
MAX_DEGREE = 4
MAX_SKETCH = 16
MAX_WARM_ITERS = 64   # alphas one K3 launch takes (csrc/warm_tail.cu)
RC_WARPS = 8      # warps of a K6 block (csrc/residual_chain.cu)
AG_TARGET_BLOCKS = 132   # blocks a K7 launch aims at: the H100's SMs
FAMILIES = ("polar", "sign", "sqrt")   # the kernels' family codes 0, 1, 2


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def smem_bytes(m: int, n: int, itemsize: int, coupled: bool = False) -> int:
    """Shared memory one K3 block needs for an [m, n] slice: X and the
    rounded Horner operand ([m, n] each), R ([n, n]) and, coupled, Y
    ([n, n]), all in the operand dtype and 16-byte aligned, plus the fp32
    accumulator, whose rows the coupled family pads to n + 1."""
    c = int(coupled)
    return 2 * _align16(m * n * itemsize) + \
        (1 + c) * _align16(n * n * itemsize) + 4 * m * (n + c)


def tile_pitch(cols: int) -> int:
    """Row pitch (elements) of a K6/K7 shared operand with ``cols``
    columns (``csrc/tiles.cuh``): a multiple of 4 whose quarter is odd."""
    return (cols + 7) // 8 * 8 + 4


def residual_chain_smem_bytes(m: int, n: int, p: int, itemsize: int,
                              coupled: bool = False) -> int:
    """Shared memory one K6 block needs: X [m, n] and R [n, n] with rows
    of ``tile_pitch(n)``, St and the two V buffers ([n, p] each) with rows
    of ``tile_pitch(p)``, all in the operand dtype and 16-byte aligned, two
    fp32 trace partials per warp and, coupled, Y [n, n] and the fp32
    residual [n, n + 1]."""
    ld = tile_pitch(n)
    need = _align16(m * ld * itemsize) + _align16(n * ld * itemsize) + \
        3 * _align16(n * tile_pitch(p) * itemsize) + 2 * 4 * RC_WARPS
    if coupled:
        need += _align16(n * ld * itemsize) + 4 * n * (n + 1)
    return need


def apply_g_rows(batch: int, m: int) -> int:
    """Rows of X (or, coupled, columns of Y) one K7 block takes: a
    multiple of 4 (or m), chosen so that a side's batch x ceil(m / rows)
    blocks come near ``AG_TARGET_BLOCKS`` (the coupled Y side adds as many
    blocks again)."""
    splits = max(1, -(-AG_TARGET_BLOCKS // batch))
    rows = -(-m // splits)
    return min(-(-rows // 4) * 4, m)


def apply_g_smem_bytes(m: int, n: int, itemsize: int,
                       coupled: bool = False, rows: Optional[int] = None
                       ) -> int:
    """Shared memory one K7 block needs: R [n, n] and three buffers of its
    share of the slice (its ``rows`` rows of X or, coupled, [n, rows]
    columns of Y, and the two rounded Horner operands), all in the operand
    dtype with the pitch of ``tile_pitch`` and 16-byte aligned.  ``rows``
    defaults to m, the most any launch takes (the fused tier's model)."""
    rows = m if rows is None else rows
    ld = tile_pitch(n)
    chunk = rows * ld
    if coupled:
        chunk = max(chunk, n * tile_pitch(rows))
    return _align16(n * ld * itemsize) + 3 * _align16(chunk * itemsize)


def _family_code(name: str, family: str, Y: Optional[torch.Tensor],
                 X: torch.Tensor) -> int:
    if family not in FAMILIES:
        raise ValueError(f"{name}: unknown family {family!r}")
    if (family == "sqrt") != (Y is not None):
        raise ValueError(f"{name}: the sqrt family takes Y, the others "
                         f"do not (family {family!r})")
    if family != "polar" and X.shape[-1] != X.shape[-2]:
        raise ValueError(f"{name}: the {family} family needs square X, got "
                         f"{tuple(X.shape)}")
    if Y is not None and tuple(Y.shape) != tuple(X.shape):
        raise ValueError(f"{name}: Y {tuple(Y.shape)} is not X's shape "
                         f"{tuple(X.shape)}")
    return FAMILIES.index(family)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_smem(name: str, need: int, m: int, n: int, dtype) -> None:
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: an [{m}, {n}] {dtype} slice needs "
                         f"{need} bytes of shared memory, more than the "
                         f"{MAX_SMEM_BYTES} a block has; use the grid tier")


_SYMBOL = "prism_warm_tail"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_float)] + \
    [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def warm_tail(X: torch.Tensor, alphas: Sequence[float], *,
              coeffs: Sequence[float], family: str = "polar",
              Y: Optional[torch.Tensor] = None):
    """Launch K3 on a contiguous CUDA tensor X [Bt, m, n] (fp32 or bf16;
    square for sign and sqrt) and, for sqrt, Y [Bt, n, n]:
    ``len(alphas)`` iterations (at most ``MAX_WARM_ITERS``), one launch.
    ``coeffs`` are the ascending Taylor coefficients f_0..f_{d-1} of g_d.
    Returns X', or (X', Y') for sqrt."""
    _build.check_cuda_operands("warm_tail", (X,) if Y is None else (X, Y))
    code = _family_code("warm_tail", family, Y, X)
    nb, m, n = X.shape
    degree = len(coeffs)
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"warm_tail: degree {degree} outside "
                         f"1..{MAX_DEGREE}")
    if len(alphas) > MAX_WARM_ITERS:
        raise ValueError(f"warm_tail: {len(alphas)} iterations, more than "
                         f"the {MAX_WARM_ITERS} one launch takes")
    smem = smem_bytes(m, n, X.element_size(), coupled=Y is not None)
    _check_smem("warm_tail", smem, m, n, X.dtype)
    x_out = torch.empty_like(X)
    y_out = None if Y is None else torch.empty_like(Y)
    if x_out.numel() == 0 or not alphas:
        x_out.copy_(X)
        if Y is not None:
            y_out.copy_(Y)
    else:
        a = (ctypes.c_float * len(alphas))(*[float(v) for v in alphas])
        c = (ctypes.c_float * degree)(*[float(v) for v in coeffs])
        lib = _build.library("warm_tail", _SYMBOL, _ARGTYPES)
        with torch.cuda.device(X.device):
            _build.launch("warm_tail", lib, _SYMBOL, X.data_ptr(), _ptr(Y),
                          x_out.data_ptr(), _ptr(y_out), a, len(alphas), nb,
                          m, n, degree, c, code, smem,
                          int(X.dtype == torch.bfloat16),
                          _build.stream_handle(X))
    return x_out if Y is None else (x_out, y_out)


_RC_SYMBOL = "prism_residual_chain"
_RC_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
    [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def residual_chain(X: torch.Tensor, St: torch.Tensor, max_power: int, *,
                   family: str = "polar", Y: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on a contiguous CUDA X [Bt, m, n] (square for sign and
    sqrt; with Y [Bt, n, n] for sqrt) and St [n, p] (one dtype): (R
    [Bt, n, n] in X's dtype, fp32 traces [Bt, max_power] of powers
    1..max_power), one launch."""
    _build.check_cuda_operands("residual_chain",
                               (X,) if Y is None else (X, Y))
    code = _family_code("residual_chain", family, Y, X)
    nb, m, n = X.shape
    _build.check_companion("residual_chain", X, St)
    if St.dim() != 2 or St.shape[0] != n or \
            not 1 <= St.shape[1] <= MAX_SKETCH:
        raise ValueError(f"residual_chain: St must be [{n}, p] with p in "
                         f"1..{MAX_SKETCH}, got {tuple(St.shape)}")
    p = St.shape[1]
    smem = residual_chain_smem_bytes(m, n, p, X.element_size(),
                                     coupled=Y is not None)
    _check_smem("residual_chain", smem, m, n, X.dtype)
    R = torch.empty((nb, n, n), dtype=X.dtype, device=X.device)
    t = torch.empty((nb, max_power), dtype=torch.float32, device=X.device)
    if R.numel() == 0:
        return R, t.zero_()
    lib = _build.library("residual_chain", _RC_SYMBOL, _RC_ARGTYPES)
    with torch.cuda.device(X.device):
        _build.launch("residual_chain", lib, _RC_SYMBOL, X.data_ptr(),
                      _ptr(Y), St.data_ptr(), R.data_ptr(), t.data_ptr(),
                      nb, m, n, p, max_power, code, smem,
                      int(X.dtype == torch.bfloat16),
                      _build.stream_handle(X))
    return R, t


_AG_SYMBOL = "prism_apply_g"
_AG_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
    [ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
     ctypes.c_void_p]


def apply_g(X: torch.Tensor, R: torch.Tensor, alpha: torch.Tensor, *,
            coeffs: Sequence[float], Y: Optional[torch.Tensor] = None):
    """Launch K7 on contiguous CUDA X [Bt, m, n], R [Bt, n, n] (one dtype)
    and alpha [Bt] fp32 on the same device: X g_d(R; alpha) with alpha
    read per slice on the device, one launch; with Y [Bt, n, n] (square
    X) also g_d(R; alpha) Y in the same launch, returning (X', Y').
    ``coeffs`` are the ascending Taylor coefficients f_0..f_{d-1} of g_d."""
    _build.check_cuda_operands("apply_g",
                               (X, R) if Y is None else (X, R, Y))
    nb, m, n = X.shape
    if tuple(R.shape) != (nb, n, n):
        raise ValueError(f"apply_g: R {tuple(R.shape)} is not {(nb, n, n)}")
    if Y is not None and (m != n or tuple(Y.shape) != (nb, n, n)):
        raise ValueError(f"apply_g: the coupled application needs square X "
                         f"and Y of X's shape, got {tuple(X.shape)} and "
                         f"{tuple(Y.shape)}")
    if not (torch.is_tensor(alpha) and alpha.dtype == torch.float32
            and alpha.device == X.device and tuple(alpha.shape) == (nb,)
            and alpha.is_contiguous()):
        raise ValueError(f"apply_g: alpha must be a contiguous fp32 [{nb}] "
                         f"tensor on {X.device}")
    degree = len(coeffs)
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"apply_g: degree {degree} outside "
                         f"1..{MAX_DEGREE}")
    rows = apply_g_rows(nb, m)
    smem = apply_g_smem_bytes(m, n, X.element_size(), coupled=Y is not None,
                              rows=rows)
    _check_smem("apply_g", smem, m, n, X.dtype)
    out = torch.empty_like(X)
    y_out = None if Y is None else torch.empty_like(Y)
    if out.numel():
        c = (ctypes.c_float * degree)(*[float(v) for v in coeffs])
        lib = _build.library("apply_g", _AG_SYMBOL, _AG_ARGTYPES)
        with torch.cuda.device(X.device):
            _build.launch("apply_g", lib, _AG_SYMBOL, X.data_ptr(), _ptr(Y),
                          R.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                          _ptr(y_out), nb, m, n, rows, degree, c, smem,
                          int(X.dtype == torch.bfloat16),
                          _build.stream_handle(X))
    return out if Y is None else (out, y_out)
