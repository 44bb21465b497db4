"""Newton-Schulz polar iteration, classical and PRISM warm-start
(counterpart of ``repro/core/newton_schulz.py``, polar family).

    X_{k+1} = X_k g_d(R_k; a),  R_k = I - X_k^T X_k          (Thm 4)

for d=1 (3rd order) and d=2 (5th order).  ``alpha`` per iteration is the
classical Taylor coefficient or the fixed warm value u (paper Sec. C).
All entry points broadcast over leading batch dims (stacked layer params).

Phase structure (DESIGN.md §10): a chain is a sequence of WARM phases —
maximal runs of iterations whose alpha is a static float — and FIT
iterations, whose alpha is the sketched argmin.  With ``use_kernels`` and
the fused tier engaged, a warm phase runs as ONE ``warm_tail`` launch;
otherwise each iteration is one ``gram`` launch plus d ``matmul_add``
launches (the §7 grid tier).  The two tiers keep their own rounding
orders: the grid tier rounds the accumulator to the compute dtype after
every GEMM and starts from (alpha X) rounded; the fused tier keeps the
f_j X epilogues in fp32 and rounds only each GEMM's operand.

Not ported yet, and raising: fitted iterations and the adaptive ``tol``
loop (slice 2, ROADMAP.md Queue 1 items 2-3), the sign and coupled sqrt
families (item 6).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import PrismConfig, torch_dtype
from repro_torch.core import polynomials as poly
from repro_torch.kernels import ref as kref

_TINY = float(np.finfo(np.float32).tiny)


def _fro(M: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(M.float()), dim=(-2, -1),
                                keepdim=True))


def _safe_fro(M: torch.Tensor) -> torch.Tensor:
    """||M||_F clamped away from zero for the entry-point normalization.

    A zero slice (rank-collapsed momentum, freshly padded bucket slot)
    would otherwise normalize as 0/0 = NaN before the first iteration.
    Clamping to the smallest normal fp32 leaves every slice with
    ||M||_F >= tiny bit-identical and turns zero slices into exact zero
    pass-throughs, which the chains then keep at X = 0.
    """
    return torch.clamp(_fro(M), min=_TINY)


def _mm(A, B, use_kernels: bool = False, alpha: float = 1.0, C=None,
        beta: float = 0.0):
    """alpha * A @ B (+ beta * C): K1 when ``use_kernels``, else its plain
    version, which keeps the kernel's accumulation order exactly
    (DESIGN.md §9): fp32 products and sums whatever the operand dtype, the
    epilogue on the fp32 accumulator, one rounding at the end.
    """
    if use_kernels:
        from repro_torch.kernels import ops as kops

        return kops.matmul_add(A, B, C=C, alpha=alpha, beta=beta)
    return kref.matmul_add(A, B, C, alpha=alpha, beta=beta)


def _gram_residual(X: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    """R = I - X^T X (symmetric; K2 when enabled, else its plain version),
    fp32-accumulated and rounded once to the compute dtype."""
    if use_kernels:
        from repro_torch.kernels import ops as kops

        return kops.gram(X, alpha=1.0, beta=-1.0)
    return kref.gram(X, alpha=1.0, beta=-1.0)


def apply_g(X: torch.Tensor, R: torch.Tensor, alpha, d: int,
            use_kernels: bool = False) -> torch.Tensor:
    """X @ g_d(R; alpha) (the left-side application of the coupled sqrt
    family comes with Shampoo, ROADMAP.md Queue 1 item 6).

    g_d(x; a) = f_{d-1}(x) + a x^d with f the Taylor series of
    (1-x)^{-1/2}, evaluated as a chain of d GEMMs (Horner on R), never
    forming g(R).  alpha multiplies the fp32 X and the product rounds once
    to the compute dtype (DESIGN.md §9).  ``alpha`` is a float or an fp32
    tensor over the leading dims.
    """
    f = poly.taylor_inv_sqrt(d - 1)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=X.device)
    if alpha.dim():
        alpha = alpha[..., None, None]
    acc = (alpha * X.float()).to(X.dtype)
    for j in range(d - 1, -1, -1):
        acc = _mm(acc, R, use_kernels, C=X, beta=float(f[j]))
    return acc


def _classical_alpha(d: int) -> float:
    return float(poly.taylor_inv_sqrt(d)[d])


# ---------------------------------------------------------------------------
# Phase plan + fused-tier routing (DESIGN.md §10)
# ---------------------------------------------------------------------------


def _static_alpha(k: int, cfg: PrismConfig, method: str) -> Optional[float]:
    """alpha_k when it is a constant, else None (fit)."""
    if method == "newton_schulz":
        return _classical_alpha(cfg.degree)
    if method != "prism":
        raise ValueError(f"unknown Newton-Schulz method {method!r}")
    if k < cfg.warm_alpha_iters:
        return float(cfg.bounds[1])
    return None


def _phase_plan(iters: int, cfg: PrismConfig,
                method: str) -> List[Tuple[str, object]]:
    """[("warm", (a_0, ..)), ("fit", (k0, count)), ...] — maximal runs of
    static-alpha iterations become single warm phases (one fused launch,
    §10) and maximal runs of fitted iterations single fit phases."""
    phases: List[Tuple[str, object]] = []
    for k in range(iters):
        a = _static_alpha(k, cfg, method)
        if a is None:
            if phases and phases[-1][0] == "fit":
                k0, count = phases[-1][1]
                phases[-1] = ("fit", (k0, count + 1))
            else:
                phases.append(("fit", (k, 1)))
        else:
            if phases and phases[-1][0] == "warm":
                phases[-1] = ("warm", phases[-1][1] + (a,))
            else:
                phases.append(("warm", (a,)))
    return phases


def _fused_tier(cfg: PrismConfig, mshape) -> bool:
    """Fused-tier choice: kernels on and the slice fits one block's shared
    memory.  ``fuse="on"`` on a shape that does not fit raises: an
    over-budget kernel is never launched."""
    if not cfg.use_kernels or cfg.fuse == "off":
        return False
    from repro_torch.kernels import ops as kops

    fits = kops.fused_fits(mshape, cfg.dtype, budget=cfg.vmem_budget)
    if cfg.fuse == "on" and not fits:
        raise ValueError(
            f"PrismConfig.fuse='on' but an {tuple(mshape)} {cfg.dtype} "
            f"slice needs {kops.fused_smem_bytes(mshape, cfg.dtype)} bytes "
            f"of shared memory, over the budget of "
            f"{kops.smem_budget(cfg.vmem_budget)}")
    return fits


def _run_phases(X, cfg: PrismConfig, method: str, iters: int):
    """Warm phase driver of the polar family (§10); fit phases raise."""
    fused = _fused_tier(cfg, X.shape[-2:])
    for kind, payload in _phase_plan(iters, cfg, method):
        if kind == "fit":
            raise NotImplementedError(
                "fitted PRISM iterations (PrismConfig.iterations > "
                "warm_alpha_iters) are ported with slice 2 "
                "(ROADMAP.md Queue 1 items 2-3)")
        if fused:
            from repro_torch.kernels import ops as kops

            X = kops.warm_tail(X, payload, degree=cfg.degree,
                               family="polar")
            continue
        for a in payload:
            R = _gram_residual(X, cfg.use_kernels)
            X = apply_g(X, R, a, cfg.degree, cfg.use_kernels)
    return X


def polar(A: torch.Tensor, cfg: Optional[PrismConfig] = None,
          method: str = "prism", iters: Optional[int] = None):
    """Polar factor U V^T of A [..., m, n] via (PRISM-)Newton-Schulz.

    method: "prism" (warm iterations only, for now) | "newton_schulz"
    (classical Taylor alpha).
    """
    cfg = PrismConfig() if cfg is None else cfg
    if cfg.tol is not None:
        raise NotImplementedError(
            "adaptive early stopping (PrismConfig.tol) needs the fitted "
            "iterations and is ported with slice 2 (ROADMAP.md Queue 1 "
            "item 3)")
    iters = cfg.iterations if iters is None else iters
    transpose = A.shape[-2] < A.shape[-1]
    X = A.transpose(-1, -2) if transpose else A
    in_dtype = X.dtype
    dt = torch_dtype(cfg.dtype)
    X = X.to(dt) / _safe_fro(X).to(dt)
    X = _run_phases(X, cfg, method, iters)
    X = X.transpose(-1, -2) if transpose else X
    return X.to(in_dtype)
