"""Newton-Schulz iterations, classical and PRISM (counterpart of
``repro/core/newton_schulz.py``):

  * matrix sign              X_{k+1} = X_k g_d(R_k; a),  R_k = I - X_k^2
  * square / inverse sqrt    coupled (X, Y), R_k = sym(I - Y_k X_k),
                             X <- X g_d(R; a), Y <- g_d(R; a) Y    (Thm 3)
  * polar factor U V^T       R_k = I - X_k^T X_k                   (Thm 4)

for d=1 (3rd order) and d=2 (5th order).  ``alpha`` per iteration is the
classical Taylor coefficient, the fixed warm value u (paper Sec. C), or
the PRISM sketched fit (core/prism.py).  All entry points broadcast over
leading batch dims (stacked layer params).

Phase structure (DESIGN.md §10): a chain is a sequence of WARM phases —
maximal runs of iterations whose alpha is a static float — and FIT
iterations, whose alpha is the sketched argmin.  With ``use_kernels`` and
the fused tier engaged, a warm phase runs as ONE ``warm_tail`` launch and
a fitted iteration as TWO (``residual_chain``, then ``apply_g``) with the
closed-form fit between them as torch ops on the device; otherwise each
iteration is one ``gram`` launch, the fit (one ``sketch_traces`` launch)
and d ``matmul_add`` launches (the §7 grid tier: 2+d).  The fitted alpha
stays an fp32 device tensor from the fit into the update: nothing is read
back to the host.

The two tiers keep their own rounding orders: the grid tier rounds the
accumulator to the compute dtype after every GEMM and starts from
(alpha X) rounded; the fused tier keeps the f_j X epilogues in fp32 and
rounds only each GEMM's operand.  The coupled residual differs the same
way: the grid tier rounds Y X, subtracts it from I and symmetrizes in the
compute dtype; the fused tier does all three on the fp32 accumulator and
rounds once.

Adaptive early stopping (DESIGN.md §11): with ``cfg.tol`` set, each
maximal run of fitted iterations becomes one certify-then-freeze loop
(``prism.adaptive_masked_loop``) reading the certificate est_r ~ ||R||_F
off the trace chain the fit already computes; ``iterations`` is then a
budget, and ``return_iters`` / ``return_status`` surface the per-matrix
counts and guardian codes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import PrismConfig, torch_dtype
from repro_torch.core import polynomials as poly
from repro_torch.core import prism
from repro_torch.core import sketch as sk
from repro_torch.kernels import ref as kref

_TINY = float(np.finfo(np.float32).tiny)


class IterInfo(NamedTuple):
    alphas: torch.Tensor        # [iters, ...]
    residual_fro: torch.Tensor  # [iters, ...] ||R_k||_F before each update


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


def _coupled_residual(X, Y, use_kernels: bool) -> torch.Tensor:
    """R = sym(I - Y X) on the grid tier (Thm 3 coupling: X <- X h(YX),
    Y <- h(YX) Y, Higham's stable form).  Y X rounds to the compute dtype
    (K1 when enabled), then I - (.) and the re-symmetrization run in the
    compute dtype, as in the reference."""
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    R = eye - _mm(Y, X, use_kernels)
    return 0.5 * (R + R.transpose(-1, -2))


def _sign_residual(X, use_kernels: bool) -> torch.Tensor:
    """R = I - X X on the grid tier: X X rounds (K1 when enabled), the
    subtraction runs in the compute dtype."""
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return eye - _mm(X, X, use_kernels)


def apply_g(X: torch.Tensor, R: torch.Tensor, alpha, d: int,
            side: str = "right", use_kernels: bool = False) -> torch.Tensor:
    """X @ g_d(R; alpha) (``side="right"``) or g_d(R; alpha) @ X
    (``"left"``).

    g_d(x; a) = f_{d-1}(x) + a x^d with f the Taylor series of
    (1-x)^{-1/2}, evaluated as a chain of d GEMMs (Horner on R), never
    forming g(R).  alpha multiplies the fp32 X and the product rounds once
    to the compute dtype (DESIGN.md §9).  ``alpha`` is a float or an fp32
    tensor over the leading dims.
    """
    f = poly.taylor_inv_sqrt(d - 1)
    if torch.is_tensor(alpha):
        alpha = alpha.to(torch.float32)
        if alpha.dim():
            alpha = alpha[..., None, None]
    acc = (alpha * X.float()).to(X.dtype)
    for j in range(d - 1, -1, -1):
        if side == "right":
            acc = _mm(acc, R, use_kernels, C=X, beta=float(f[j]))
        else:
            acc = _mm(R, acc, use_kernels, C=X, beta=float(f[j]))
    return acc


def _classical_alpha(d: int) -> float:
    return float(poly.taylor_inv_sqrt(d)[d])


def _resolve_alpha(k: int, R: torch.Tensor, cfg: PrismConfig, method: str,
                   key, n_real: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """alpha_k: the classical coefficient or the warm/PRISM-fit value."""
    if method == "newton_schulz":
        return torch.full(R.shape[:-2], _classical_alpha(cfg.degree),
                          dtype=torch.float32, device=R.device)
    return prism.resolve_alpha(k, R, poly.newton_schulz_residual(cfg.degree),
                               cfg, key, n_real=n_real)


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
    §10) and maximal runs of fitted iterations single fit phases (a
    budget, not a cost, when ``cfg.tol`` is set)."""
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


def _fused_tier(cfg: PrismConfig, mshape, return_info: bool = False,
                coupled: bool = False) -> bool:
    """Fused-tier choice: kernels on, not a diagnostics run (``return_info``
    needs per-iteration residuals the fused launches never materialize),
    and the slice (with the coupled family's Y when ``coupled``) fits one
    block's shared memory in every fused kernel.  ``fuse="on"`` on a shape
    that does not fit raises: an over-budget kernel is never launched."""
    if not cfg.use_kernels or return_info or cfg.fuse == "off":
        return False
    from repro_torch.kernels import ops as kops

    fits = kops.fused_fits(mshape, cfg.dtype, budget=cfg.vmem_budget,
                           sketch_dim=cfg.sketch_dim, coupled=coupled)
    if cfg.fuse == "on" and not fits:
        need = kops.fused_smem_bytes(mshape, cfg.dtype,
                                     sketch_dim=cfg.sketch_dim,
                                     coupled=coupled)
        raise ValueError(
            f"PrismConfig.fuse='on' but an {tuple(mshape)} {cfg.dtype} "
            f"slice{' pair' if coupled else ''} needs {need} bytes of "
            f"shared memory, over the budget of "
            f"{kops.smem_budget(cfg.vmem_budget)}")
    return fits


def _fused_fit(X, cfg: PrismConfig, k: int, key, n_real, family: str,
               Y=None):
    """(R, alpha, est_r) of fitted iteration k on the fused tier: the
    family residual and its sketched chain in one launch (K6), then the
    closed-form fit as torch ops on the device."""
    from repro_torch.kernels import ops as kops

    apoly = poly.newton_schulz_residual(cfg.degree)
    lo, hi = cfg.bounds
    S = sk.gaussian_sketch(prism.alpha_schedule_key(key, k), cfg.sketch_dim,
                           X.shape[-1], dtype=X.dtype, device=X.device)
    R, t = kops.residual_chain(X, S, poly.max_trace_power(apoly),
                               family=family, Y=Y)
    a, est = prism.fit_alpha_from_traces(t, apoly, lo, hi, S=S,
                                         n_real=n_real, return_est_r=True)
    return R, a, est


def _fused_fit_step(X, cfg: PrismConfig, k: int, key, n_real, family: str,
                    Y=None):
    """One fitted iteration in TWO launches: K6 with the fit, then the
    Horner application with the fitted alpha (K7; X' or, coupled,
    (X', Y'))."""
    from repro_torch.kernels import ops as kops

    R, a, _ = _fused_fit(X, cfg, k, key, n_real, family, Y)
    return kops.apply_g(X, R, a, degree=cfg.degree, Y=Y)


def _grid_update(X, Y, R, a, cfg: PrismConfig):
    """One §7-tier update from R: X g_d(R; a) and, coupled, g_d(R; a) Y
    (d K1 launches a side)."""
    X = apply_g(X, R, a, cfg.degree, "right", cfg.use_kernels)
    if Y is not None:
        Y = apply_g(Y, R, a, cfg.degree, "left", cfg.use_kernels)
    return X, Y


def _adaptive_fit_run(X, Y, cfg: PrismConfig, k0: int, count: int, key,
                      n_real, family: str, residual_fn, fused: bool):
    """A maximal run of fitted iterations as one certify-then-freeze loop
    (DESIGN.md §11, ``prism.adaptive_masked_loop``).  Each loop step is
    the body of one fitted iteration — 2 launches on the fused tier, 2+d
    on the §7 tier (1 + 1 + 2d for the coupled family) — issued once per
    runtime iteration; the coupled iterates freeze together.  Returns
    (X, Y, used, status)."""
    coupled = Y is not None
    apoly = poly.newton_schulz_residual(cfg.degree)
    lo, hi = cfg.bounds
    use_fused_fit = fused and key is not None and cfg.sketch_dim > 0
    if fused:
        from repro_torch.kernels import ops as kops

    def fit(it, k):
        """(R, alpha, est_r) for iteration k."""
        X_, Y_ = it["X"], it.get("Y")
        if use_fused_fit:
            return _fused_fit(X_, cfg, k, key, n_real, family, Y_)
        R = residual_fn(X_, Y_)
        kk = prism.alpha_schedule_key(key, k) if key is not None else None
        a, est = prism.fit_alpha(R, apoly, lo, hi, key=kk,
                                 sketch_dim=cfg.sketch_dim,
                                 use_kernels=cfg.use_kernels,
                                 n_real=n_real, vmem_budget=cfg.vmem_budget,
                                 return_est_r=True)
        return R, a, est

    def step(it, R, a):
        X_, Y_ = it["X"], it.get("Y")
        if fused:
            out = kops.apply_g(X_, R, a, degree=cfg.degree, Y=Y_)
            Xn, Yn = out if coupled else (out, None)
        else:
            Xn, Yn = _grid_update(X_, Y_, R, a, cfg)
        return {"X": Xn, "Y": Yn} if coupled else {"X": Xn}

    iterates = {"X": X, "Y": Y} if coupled else {"X": X}
    out, used, status = prism.adaptive_masked_loop(
        iterates, fit, step, cfg.tol, k0, count, tuple(X.shape[:-2]),
        divergence_factor=cfg.divergence_factor)
    return out["X"], out.get("Y", Y), used, status


def _run_phases(X, cfg: PrismConfig, method: str, iters: int, key,
                return_info: bool, family: str, residual_fn, Y=None,
                n_real=None):
    """Warm/fit phase driver shared by the three families (§10/§11).

    ``residual_fn(X, Y)`` is the family residual on the §7 tier; ``Y`` is
    set only for the coupled sqrt family, whose two iterates update
    together in every phase.  Returns (X, Y, alphas, fros, iters_used,
    status): the info lists are filled only under ``return_info`` (which
    turns off the fused tier and the adaptive loop); ``iters_used`` is the
    per-matrix count of applied updates and ``status`` the per-matrix
    int8 guardian code, the severity maximum over the adaptive fit runs
    (zeros on static chains).
    """
    coupled = Y is not None
    fused = _fused_tier(cfg, X.shape[-2:], return_info, coupled=coupled)
    if fused:
        from repro_torch.kernels import ops as kops
    alphas, fros = [], []
    lead = tuple(X.shape[:-2])
    iters_used = torch.zeros(lead, dtype=torch.int32, device=X.device)
    status = torch.zeros(lead, dtype=torch.int8, device=X.device)
    adaptive = cfg.tol is not None and not return_info

    def unpack(out):
        return out if coupled else (out, Y)

    for kind, payload in _phase_plan(iters, cfg, method):
        if kind == "warm":
            iters_used = iters_used + len(payload)
            if fused:
                X, Y = unpack(kops.warm_tail(X, payload, degree=cfg.degree,
                                             family=family, Y=Y))
                continue
            for a in payload:
                R = residual_fn(X, Y)
                X, Y = _grid_update(X, Y, R, a, cfg)
                if return_info:
                    alphas.append(torch.full(lead, a, dtype=torch.float32,
                                             device=X.device))
                    fros.append(_fro(R)[..., 0, 0])
            continue
        k0, count = payload
        if adaptive:
            X, Y, used, st = _adaptive_fit_run(X, Y, cfg, k0, count, key,
                                               n_real, family, residual_fn,
                                               fused)
            iters_used = iters_used + used
            status = torch.maximum(status, st)
            continue
        for k in range(k0, k0 + count):
            iters_used = iters_used + 1
            if fused and key is not None and cfg.sketch_dim > 0:
                X, Y = unpack(_fused_fit_step(X, cfg, k, key, n_real, family,
                                              Y))
                continue
            R = residual_fn(X, Y)
            a = _resolve_alpha(k, R, cfg, method, key, n_real=n_real)
            if fused:
                X, Y = unpack(kops.apply_g(X, R, a, degree=cfg.degree, Y=Y))
            else:
                X, Y = _grid_update(X, Y, R, a, cfg)
            if return_info:
                alphas.append(a)
                fros.append(_fro(R)[..., 0, 0])
    return X, Y, alphas, fros, iters_used, status


def _with_telemetry(out, info, iters_used, return_info, return_iters,
                    status=None, return_status=False):
    """(out[, IterInfo][, iters_used][, status]) per the telemetry flags."""
    res = (out,)
    if return_info:
        alphas, fros = info
        res = res + (IterInfo(torch.stack(alphas), torch.stack(fros)),)
    if return_iters:
        res = res + (iters_used,)
    if return_status:
        res = res + (status,)
    return res if len(res) > 1 else res[0]


def polar(A: torch.Tensor, cfg: Optional[PrismConfig] = None,
          method: str = "prism", iters: Optional[int] = None, key=None,
          return_info: bool = False, n_real: Optional[torch.Tensor] = None,
          return_iters: bool = False, return_status: bool = False):
    """Polar factor U V^T of A [..., m, n] via (PRISM-)Newton-Schulz.

    method: "prism" | "newton_schulz" (classical Taylor alpha).
    key: sketch key of the fitted iterations (``core.rng.Key`` or anything
      with ``fold_in``/``normal``); None fits alpha from exact traces.
    n_real: per-matrix real extent of the Gram dimension (the min(m, n)
      side) when A is a zero-padded bucket stack; makes the fit ignore the
      padding exactly.
    return_info: also return ``IterInfo`` (per-iteration alphas and
      residual norms; turns the fused tier off).
    return_iters: also return the per-matrix number of applied iterations
      (int32, shape A.shape[:-2]).
    return_status: also return the per-matrix int8 guardian status
      (prism.STATUS_*), all zeros unless ``cfg.tol`` runs the certificate.
    """
    cfg = PrismConfig() if cfg is None else cfg
    iters = cfg.iterations if iters is None else iters
    transpose = A.shape[-2] < A.shape[-1]
    X = A.transpose(-1, -2) if transpose else A
    in_dtype = X.dtype
    dt = torch_dtype(cfg.dtype)
    X = X.to(dt) / _safe_fro(X).to(dt)
    X, _, alphas, fros, used, status = _run_phases(
        X, cfg, method, iters, key, return_info, "polar",
        lambda x, y: _gram_residual(x, cfg.use_kernels), n_real=n_real)
    X = X.transpose(-1, -2) if transpose else X
    X = X.to(in_dtype)
    return _with_telemetry(X, (alphas, fros), used, return_info,
                           return_iters, status, return_status)


# ---------------------------------------------------------------------------
# Coupled square root / inverse square root (Higham Thm 3), matrix sign
# ---------------------------------------------------------------------------


def sqrtm(A: torch.Tensor, cfg: Optional[PrismConfig] = None,
          method: str = "prism", iters: Optional[int] = None, key=None,
          return_info: bool = False, return_iters: bool = False,
          return_status: bool = False):
    """(A^{1/2}, A^{-1/2}) for symmetric PSD A [..., n, n] via the coupled
    (PRISM-)Newton-Schulz iteration from X = A / ||A||_F, Y = I, with the
    outputs rescaled by sqrt(||A||_F).  With ``cfg.tol`` both iterates of
    a slice freeze together once its certificate est_r ~ ||I - Y X||_F
    clears tol (DESIGN.md §11); the telemetry flags are ``polar``'s."""
    cfg = PrismConfig() if cfg is None else cfg
    iters = cfg.iterations if iters is None else iters
    in_dtype = A.dtype
    dt = torch_dtype(cfg.dtype)
    c = _safe_fro(A).to(dt)
    X = A.to(dt) / c
    Y = torch.eye(X.shape[-1], dtype=dt, device=X.device).expand(X.shape)
    X, Y, alphas, fros, used, status = _run_phases(
        X, cfg, method, iters, key, return_info, "sqrt",
        lambda x, y: _coupled_residual(x, y, cfg.use_kernels), Y=Y)
    sqrt_c = torch.sqrt(c)
    out = (X * sqrt_c).to(in_dtype), (Y / sqrt_c).to(in_dtype)
    return _with_telemetry(out, (alphas, fros), used, return_info,
                           return_iters, status, return_status)


def signm(A: torch.Tensor, cfg: Optional[PrismConfig] = None,
          method: str = "prism", iters: Optional[int] = None, key=None,
          return_info: bool = False, return_iters: bool = False,
          return_status: bool = False):
    """sign(A) for A [..., n, n] with A^2 symmetric and ||A||_2 <= 1 after
    the ||.||_F scaling; the telemetry flags are ``polar``'s."""
    cfg = PrismConfig() if cfg is None else cfg
    iters = cfg.iterations if iters is None else iters
    in_dtype = A.dtype
    dt = torch_dtype(cfg.dtype)
    X = A.to(dt) / _safe_fro(A).to(dt)
    X, _, alphas, fros, used, status = _run_phases(
        X, cfg, method, iters, key, return_info, "sign",
        lambda x, y: _sign_residual(x, cfg.use_kernels))
    return _with_telemetry(X.to(in_dtype), (alphas, fros), used, return_info,
                           return_iters, status, return_status)
