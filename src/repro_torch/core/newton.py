"""DB-Newton iteration for matrix square roots (paper App. A.2; counterpart
of ``repro/core/newton.py``).

Product-form Denman-Beavers with PRISM acceleration.  The alpha objective
||I - M_{k+1}||_F^2 has closed-form quartic coefficients computable in
O(n^2) from entrywise sums of M and M^{-1}, so no sketch is drawn; Newton
for the square root converges globally, and the fit is clipped to a wide
[0, 2] that holds the classical a = 1/2.

One Cholesky solve an iteration supplies M^{-1} (``torch.linalg``: cuSOLVER
on the card, LAPACK on the CPU, as the reference's baseline runs LAPACK).
"""
from __future__ import annotations

import torch

from repro_torch.config import torch_dtype
from repro_torch.core.newton_schulz import IterInfo, _fro
from repro_torch.core.polynomials import minimize_quartic


def _inv_spd(M: torch.Tensor) -> torch.Tensor:
    """M^{-1} for symmetric positive definite M via Cholesky.  A slice whose
    factorization fails comes out NaN, as ``jnp.linalg.cholesky`` returns
    it, instead of raising: ``cholesky_ex`` leaves its status on the
    device, so no call reads it back to the host."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    eye = torch.eye(M.shape[-1], dtype=M.dtype,
                    device=M.device).expand(M.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(-1, -2) @ Linv


def _tr(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1).to(torch.float32)


def sqrtm(A: torch.Tensor, iters: int = 12, method: str = "prism",
          dtype=torch.float32, alpha_bounds=(0.0, 2.0),
          return_info: bool = False):
    """(A^{1/2}, A^{-1/2}) for SPD A [..., n, n] via (PRISM-)DB-Newton,
    product form:

      M_{k+1} = 2a(1-a) I + (1-a)^2 M_k + a^2 M_k^{-1}
      X_{k+1} = (1-a) X_k + a X_k M_k^{-1}
      Y_{k+1} = (1-a) Y_k + a Y_k M_k^{-1}

    with a = 1/2 (``method="newton"``, classical) or the closed-form PRISM
    fit (``"prism"``).  ``return_info`` also returns ``IterInfo``.
    """
    in_dtype = A.dtype
    dt = torch_dtype(dtype)
    c = _fro(A).to(dt)
    M = A.to(dt) / c  # normalize for conditioning (exact-arith no-op)
    X = M
    n = M.shape[-1]
    eye = torch.eye(n, dtype=dt, device=A.device)
    Y = eye.expand(M.shape)
    alphas, fros = [], []
    for _ in range(iters):
        Minv = _inv_spd(M)
        if method == "prism":
            # ||I - M_{k+1}||_F^2 = c0 + c1 a + c2 a^2 + c3 a^3 + c4 a^4
            # (paper App. A.2); the traces of M^2, M^{-2} are entrywise
            # sums of squares
            trI = float(n)
            trM = _tr(M)
            trM2 = torch.sum(torch.square(M.float()), dim=(-2, -1))
            trMi = _tr(Minv)
            trMi2 = torch.sum(torch.square(Minv.float()), dim=(-2, -1))
            c0 = trI - 2 * trM + trM2
            c1 = -4 * trI + 8 * trM - 4 * trM2
            c2 = 10 * trI - 14 * trM + 6 * trM2 - 2 * trMi
            c3 = -12 * trI + 12 * trM - 4 * trM2 + 4 * trMi
            c4 = 6 * trI - 4 * trM + trM2 - 4 * trMi + trMi2
            coeffs = torch.stack([c0, c1, c2, c3, c4], dim=-1)
            a = minimize_quartic(coeffs, *alpha_bounds)
        else:
            a = torch.full(M.shape[:-2], 0.5, dtype=torch.float32,
                           device=A.device)
        if return_info:
            alphas.append(a)
            fros.append(_fro(eye - M)[..., 0, 0])
        ab = a.to(dt)[..., None, None]
        X = (1 - ab) * X + ab * (X @ Minv)
        Y = (1 - ab) * Y + ab * (Y @ Minv)
        M = (2 * ab * (1 - ab)) * eye + torch.square(1 - ab) * M \
            + torch.square(ab) * Minv
    sc = torch.sqrt(c)
    out = (X * sc).to(in_dtype), (Y / sc).to(in_dtype)
    if return_info:
        return out, IterInfo(torch.stack(alphas), torch.stack(fros))
    return out
