"""PolarExpress baseline (Amsel et al. 2025, Algorithm 1; counterpart of
``repro/core/polar_express.py``).

Minimax-optimal composed degree-5 polynomials for the polar factor,
pre-optimized for singular values in [1e-3, 1] — the variant the PRISM
paper compares against.  After the listed iterations the asymptotic tuple
(1.875, -1.25, 0.375) repeats.  Each update is
X <- a X + b X (X^T X) + c X (X^T X)^2.

Via Higham's Theorem 3 the same h(M) = aI + bM + cM^2 schedule runs in
coupled form for the (inverse) square root.

Every product goes through ``newton_schulz._mm``'s plain path, as the
reference's go through ``_mm`` without kernels: fp32 accumulation,
rounded once to the compute dtype.  The schedule is fixed, so nothing is
fitted and nothing is read back to the host.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config import torch_dtype
from repro_torch.core.newton_schulz import _fro, _mm

# Algorithm 1 of Amsel et al. (2025), sigma_min = 1e-3 variant.
POLAR_EXPRESS_COEFFS: Tuple[Tuple[float, float, float], ...] = (
    (8.28721201814563, -23.595886519098837, 17.300387312530933),
    (4.107059111542203, -2.9478499167379106, 0.5448431082926601),
    (3.9486908534822946, -2.908902115962949, 0.5518191394370137),
    (3.3184196573706015, -2.488488024314874, 0.51004894012372),
    (2.300652019954817, -1.6689039845747493, 0.4188073119525673),
    (1.891301407787398, -1.2679958271945868, 0.37680408948524835),
    (1.8750014808534479, -1.2500016453999487, 0.3750001645474248),
    (1.875, -1.25, 0.375),
)
_SAFETY = 1.01  # Amsel et al. divide by 1.01 * ||A||_F for bf16 safety


def _in(x: float, dt: torch.dtype) -> float:
    """``x`` rounded to ``dt``: the reference's Python-float constants take
    the compute dtype of the array they scale (JAX's weak typing), so in
    bf16 the coefficients themselves are bf16 (8.2872 -> 8.3125)."""
    return float(torch.tensor(x, dtype=dt))


def _coeff(k: int, dt: torch.dtype) -> Tuple[float, float, float]:
    abc = POLAR_EXPRESS_COEFFS[min(k, len(POLAR_EXPRESS_COEFFS) - 1)]
    return tuple(_in(x, dt) for x in abc)


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def polar(A: torch.Tensor, iters: int = 8, dtype="float32",
          return_info: bool = False):
    """Polar factor of A [..., m, n] via PolarExpress; with
    ``return_info`` also ||I - X^T X||_F before each update, [iters, ...]."""
    dt = torch_dtype(dtype)
    transpose = A.shape[-2] < A.shape[-1]
    X = A.transpose(-1, -2) if transpose else A
    in_dtype = X.dtype
    X = X.to(dt) / (_in(_SAFETY, dt) * _fro(X).to(dt))
    fros = []
    for k in range(iters):
        a, b, c = _coeff(k, dt)
        M = _mm(X.transpose(-1, -2), X)
        if return_info:
            fros.append(_fro(_eye_like(M) - M)[..., 0, 0])
        M2 = _mm(M, M)
        X = a * X + b * _mm(X, M) + c * _mm(X, M2)
    X = X.transpose(-1, -2) if transpose else X
    X = X.to(in_dtype)
    if return_info:
        return X, torch.stack(fros)
    return X


def sqrtm(A: torch.Tensor, iters: int = 8, dtype="float32",
          return_info: bool = False):
    """(A^{1/2}, A^{-1/2}) via PolarExpress in coupled form (Thm 3):
    X <- X h(YX), Y <- h(YX) Y.  The interval [1e-3, 1] on singular values
    becomes [1e-6, 1] on the eigenvalues of YX."""
    dt = torch_dtype(dtype)
    in_dtype = A.dtype
    c0 = _in(_SAFETY, dt) * _fro(A).to(dt)
    X = A.to(dt) / c0
    Y = _eye_like(X).expand(X.shape)
    fros = []
    for k in range(iters):
        a, b, c = _coeff(k, dt)
        M = _mm(Y, X)
        eye = _eye_like(M)
        if return_info:
            fros.append(_fro(eye - M)[..., 0, 0])
        M2 = _mm(M, M)
        H = a * eye.expand(M.shape) + b * M + c * M2
        X = _mm(X, H)
        Y = _mm(H, Y)
    sc = torch.sqrt(c0)
    out = (X * sc).to(in_dtype), (Y / sc).to(in_dtype)
    if return_info:
        return out, torch.stack(fros)
    return out
