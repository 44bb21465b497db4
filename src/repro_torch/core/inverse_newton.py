"""Coupled inverse-Newton iteration for A^{-1/p} (paper App. A.3;
counterpart of ``repro/core/inverse_newton.py``).

  R_k = I - M_k
  X_{k+1} = X_k (I + a_k R_k),         X_0 = I / c
  M_{k+1} = (I + a_k R_k)^p M_k,       M_0 = A / c^p
  c = (2 ||A||_F / (p+1))^{1/p}

PRISM picks a_k by minimizing the sketched Frobenius norm of the next
residual, a degree-2p polynomial in alpha (``polynomials.
inverse_newton_residual``): closed form for p <= 2, the grid scan with
Newton refinements for p >= 3.  Classical inverse Newton is a_k = 1/p,
inside the default interval [1/p, 2/p].

The chain products go through ``newton_schulz._mm`` on its plain path and
the fit through ``prism.fit_alpha`` on the plain sketched chain, as in the
reference, which runs this family outside its kernels: on the card the
whole iteration is PyTorch's own matmuls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import torch_dtype
from repro_torch.core import polynomials as poly
from repro_torch.core import prism
from repro_torch.core.newton_schulz import IterInfo, _fro, _mm


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y for a positive int y by binary exponentiation, the products
    in the order ``jax.lax.integer_pow`` takes them (x^3 = x * x^2), so
    that the rounding matches the reference's ``c ** p``."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def inv_proot(A: torch.Tensor, p: int, iters: int = 20,
              method: str = "prism", sketch_dim: int = 8, key=None,
              dtype=torch.float32,
              alpha_bounds: Optional[Tuple[float, float]] = None,
              return_info: bool = False, tol: Optional[float] = None,
              return_iters: bool = False, return_status: bool = False,
              divergence_factor: float = 10.0):
    """A^{-1/p} for SPD A [..., n, n] via (PRISM-)coupled inverse Newton.

    method: "prism" (fitted alpha) | anything else runs classical
      a = 1/p.  key: sketch key of the fits (``core.rng.Key``); None fits
      from exact traces.  dtype: the compute dtype (a torch dtype or its
      config name).
    tol: adaptive early stopping (DESIGN.md §11) with ``method="prism"``:
      both coupled iterates of a slice freeze once its sketched est_r
      ~ ||I - M_k||_F drops to tol; ``iters`` becomes a budget.
      Classical runs and ``return_info`` ignore it.
    return_info / return_iters / return_status: append ``IterInfo``
      (per-iteration alphas and ||R_k||_F), the int32 per-slice count of
      applied updates, and the int8 guardian status (``prism.STATUS_*``,
      zeros on the non-adaptive paths); ``divergence_factor`` is the
      adaptive loop's detector threshold.
    """
    in_dtype = A.dtype
    dt = torch_dtype(dtype)
    n = A.shape[-1]
    A32 = A.to(dt)
    # zero-slice guard (§15): an all-zero slice gives c = 0 and X_0 = I/c
    # would start the chain at inf; c = 1 keeps its iterates bounded (the
    # slice then exits as MAXITER, never OK)
    c_raw = (2.0 * _fro(A32).to(dt) / (p + 1)) ** (1.0 / p)
    c = torch.where(torch.isfinite(c_raw) & (c_raw > 0), c_raw,
                    torch.ones_like(c_raw))
    eye = torch.eye(n, dtype=dt, device=A.device)
    X = eye.expand(A32.shape) / c
    M = A32 / _integer_pow(c, p)
    lo, hi = alpha_bounds if alpha_bounds is not None else (1.0 / p, 2.0 / p)
    apoly = poly.inverse_newton_residual(p)
    batch = tuple(A.shape[:-2])
    adaptive = tol is not None and method == "prism" and not return_info

    def fit(R, k):
        kk = prism.alpha_schedule_key(key, k) if key is not None else None
        return prism.fit_alpha(R, apoly, lo, hi, key=kk,
                               sketch_dim=sketch_dim, return_est_r=True)

    def step(X_, M_, a):
        ab = a.to(dt)[..., None, None]
        T = eye + ab * (eye - M_)
        # fp32-accumulated chain products (DESIGN.md §9)
        Xn = _mm(X_, T)
        Mn = M_
        for _ in range(p):
            Mn = _mm(T, Mn)
        return Xn, Mn

    if adaptive:
        def afit(it, k):
            a, est = fit(eye - it["M"], k)
            return None, a, est

        def astep(it, _aux, a):
            Xn, Mn = step(it["X"], it["M"], a)
            return {"X": Xn, "M": Mn}

        out_it, used, status = prism.adaptive_masked_loop(
            {"X": X, "M": M}, afit, astep, tol, 0, iters, batch,
            divergence_factor=divergence_factor)
        X = out_it["X"]
    else:
        alphas, fros = [], []
        for k in range(iters):
            R = eye - M
            if method == "prism":
                a, _ = fit(R, k)
            else:
                a = torch.full(batch, 1.0 / p, dtype=torch.float32,
                               device=A.device)
            if return_info:
                alphas.append(a)
                fros.append(_fro(R)[..., 0, 0])
            X, M = step(X, M, a)
        used = torch.full(batch, iters, dtype=torch.int32, device=A.device)
        status = torch.zeros(batch, dtype=torch.int8, device=A.device)
    # M_k = X_k^p A is invariant, so M_k -> I gives X_k -> A^{-1/p}
    # directly; the initial 1/c scaling needs no undoing
    res = (X.to(in_dtype),)
    if return_info:
        res = res + (IterInfo(torch.stack(alphas), torch.stack(fros)),)
    if return_iters:
        res = res + (used,)
    if return_status:
        res = res + (status,)
    return res if len(res) > 1 else res[0]
