"""Chebyshev iteration for the matrix inverse (paper App. A.4; counterpart
of ``repro/core/chebyshev.py``).

  Ah = A / ||A||_F,  X_0 = Ah^T,
  R_k = I - Ah X_k,
  X_{k+1} = X_k (I + R_k + a_k R_k^2).

Classical Chebyshev is a_k = 1; PRISM fits a_k over [1/2, 2] by minimizing
||S (R^2 - a (R^2 - R^3))||_F^2, a closed-form quadratic in a.  As in the
reference, the products run through ``newton_schulz._mm`` on its plain
path and the fit on the plain sketched chain.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import torch_dtype
from repro_torch.core import polynomials as poly
from repro_torch.core import prism
from repro_torch.core.newton_schulz import IterInfo, _fro, _mm, _safe_fro


def inv(A: torch.Tensor, iters: int = 20, method: str = "prism",
        sketch_dim: int = 8, key=None, dtype=torch.float32,
        alpha_bounds=(0.5, 2.0), return_info: bool = False,
        tol: Optional[float] = None, return_iters: bool = False,
        return_status: bool = False, divergence_factor: float = 10.0):
    """A^{-1} for full-rank square A [..., n, n] via (PRISM-)Chebyshev.

    method: "prism" (fitted alpha) | anything else runs classical a = 1.
    tol: adaptive early stopping (DESIGN.md §11) with ``method="prism"``:
      a slice freezes (bitwise) once its sketched est_r ~ ||I - Ah X_k||_F
      drops to tol; ``iters`` is then a budget.  Classical runs and
      ``return_info`` ignore it.  The telemetry flags are
      ``inverse_newton.inv_proot``'s.
    """
    in_dtype = A.dtype
    dt = torch_dtype(dtype)
    n = A.shape[-1]
    # zero-slice guard (§15): a 0/0 normalization would poison X_0 before
    # the certificate ever runs
    c = _safe_fro(A).to(dt)
    Ah = A.to(dt) / c
    X = Ah.transpose(-1, -2)
    apoly = poly.chebyshev_residual()
    batch = tuple(A.shape[:-2])
    adaptive = tol is not None and method == "prism" and not return_info
    eye32 = torch.eye(n, dtype=torch.float32, device=A.device)

    def residual(X_):
        # fp32-accumulated product, subtracted from I in fp32 and rounded
        # once to the compute dtype (DESIGN.md §9)
        return (eye32 - torch.matmul(Ah.float(), X_.float())).to(dt)

    def fit(R, k):
        # R = I - Ah X is symmetric: X_0 = Ah^T makes every X_k a
        # polynomial in Ah^T Ah times Ah^T
        kk = prism.alpha_schedule_key(key, k) if key is not None else None
        return prism.fit_alpha(R, apoly, *alpha_bounds, key=kk,
                               sketch_dim=sketch_dim, return_est_r=True)

    def step(X_, R, a):
        ab = a.to(dt)[..., None, None]
        XR = _mm(X_, R)
        return X_ + XR + ab * _mm(XR, R)

    if adaptive:
        def afit(it, k):
            R = residual(it["X"])
            return (R,) + fit(R, k)

        out_it, used, status = prism.adaptive_masked_loop(
            {"X": X}, afit, lambda it, R, a: {"X": step(it["X"], R, a)},
            tol, 0, iters, batch, divergence_factor=divergence_factor)
        X = out_it["X"]
    else:
        alphas, fros = [], []
        for k in range(iters):
            R = residual(X)
            if method == "prism":
                a, _ = fit(R, k)
            else:
                a = torch.full(batch, 1.0, dtype=torch.float32,
                               device=A.device)
            if return_info:
                alphas.append(a)
                fros.append(_fro(R)[..., 0, 0])
            X = step(X, R, a)
        used = torch.full(batch, iters, dtype=torch.int32, device=A.device)
        status = torch.zeros(batch, dtype=torch.int8, device=A.device)
    res = ((X / c).to(in_dtype),)
    if return_info:
        res = res + (IterInfo(torch.stack(alphas), torch.stack(fros)),)
    if return_iters:
        res = res + (used,)
    if return_status:
        res = res + (status,)
    return res if len(res) > 1 else res[0]
