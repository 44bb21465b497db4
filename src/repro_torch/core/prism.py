"""The PRISM alpha-fitting engine (counterpart of ``repro/core/prism.py``).

Given the residual R_k of an iteration, the engine

  1. sketches the power traces t_i = tr(S_k R_k^i S_k^T)   (core/sketch.py)
  2. maps them through the iteration's fixed trace-weight matrix W to the
     coefficients of the quartic objective m(alpha)
  3. minimizes m over [l, u] in closed form.

Everything is batched over leading dims of R and stays on R's device:
alpha is an fp32 device tensor and nothing is read back to the host.  The
only host synchronization in this module is the adaptive loop's read of
``done.all()``, once per fitted iteration, when a ``tol`` is set.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import PrismConfig
from repro_torch.core import polynomials as poly
from repro_torch.core import sketch as sk


def fit_alpha(R: torch.Tensor, apoly: poly.AlphaPoly, lo: float, hi: float,
              key=None, sketch_dim: int = 8, use_kernels: bool = False,
              n_real: Optional[torch.Tensor] = None, vmem_budget: int = 0,
              return_est_r: bool = False):
    """alpha_k = argmin_{alpha in [lo, hi]} || S h(R; alpha) ||_F^2.

    R: symmetric residual [..., n, n]; key: sketch key (``core.rng.Key``),
    None => exact (unsketched) traces, as is ``sketch_dim=0``; n_real:
    per-matrix count of real dimensions of a zero-padded bucket slice
    (shape R.shape[:-2], int) — the identity pad block's contribution is
    subtracted from every trace, so the fit ignores the padding exactly.
    The sketch lives in R's dtype; everything after the trace
    accumulators is fp32 (DESIGN.md §9).  Returns alpha (fp32, shape
    R.shape[:-2]), or (alpha, est_r) with ``return_est_r``.
    """
    n = R.shape[-1]
    max_pow = poly.max_trace_power(apoly)
    if key is None or sketch_dim == 0:
        t = sk.exact_power_traces(R, max_pow)
        if n_real is not None:
            # exact traces: the I_pad block adds (n - n_real) to every tr(R^i)
            t = t - (n - n_real).to(torch.float32)[..., None]
        return fit_alpha_from_traces(t, apoly, lo, hi,
                                     return_est_r=return_est_r)
    S = sk.gaussian_sketch(key, sketch_dim, n, dtype=R.dtype,
                           device=R.device)
    t = sk.sketched_power_traces(R, S, max_pow, use_kernels=use_kernels,
                                 vmem_budget=vmem_budget)
    return fit_alpha_from_traces(t, apoly, lo, hi, S=S, n_real=n_real,
                                 return_est_r=return_est_r)


def sketch_pad_trace_correction(S: torch.Tensor, n_real: torch.Tensor
                                ) -> torch.Tensor:
    """c = sum_{j >= n_real} ||S[:, j]||^2, the i-independent contribution
    of the residual's identity pad block to every sketched power trace of
    a zero-padded polar iterate (DESIGN.md §7); fp32 from the same
    (possibly bf16-rounded) sketch values the chain consumed."""
    n = S.shape[-1]
    s2 = torch.sum(torch.square(S.float()), dim=0)  # [n]
    pad_mask = torch.arange(n, device=S.device) >= n_real[..., None]
    return torch.sum(s2 * pad_mask, dim=-1)


def fit_alpha_from_traces(t: torch.Tensor, apoly: poly.AlphaPoly, lo: float,
                          hi: float, S: Optional[torch.Tensor] = None,
                          n_real: Optional[torch.Tensor] = None,
                          return_est_r: bool = False):
    """Closed-form alpha fit from precomputed fp32 traces t[..., 0..max].

    With ``n_real`` the sketched pad-trace correction (needs ``S``) is
    applied first.  ``return_est_r`` also returns the convergence
    certificate est_r = sqrt(max(t_2, 0)), an unbiased estimate of
    ||R||_F for symmetric R read off the same chain (DESIGN.md §11).
    """
    if n_real is not None:
        t = t - sketch_pad_trace_correction(S, n_real)[..., None]
    coeffs = poly.apply_trace_weights(poly.trace_weight_matrix(apoly), t)
    alpha = poly.minimize_alpha_poly(coeffs, lo, hi)
    if return_est_r:
        return alpha, torch.sqrt(torch.clamp(t[..., 2], min=0.0))
    return alpha


def objective_value(R: torch.Tensor, apoly: poly.AlphaPoly, alpha
                    ) -> torch.Tensor:
    """Exact m(alpha) = ||h(R; alpha)||_F^2 (test/diagnostic helper)."""
    t = sk.exact_power_traces(R, poly.max_trace_power(apoly))
    coeffs = poly.apply_trace_weights(poly.trace_weight_matrix(apoly), t)
    return poly._polyval_asc(coeffs, torch.as_tensor(
        alpha, dtype=torch.float32, device=R.device))


def alpha_schedule_key(key, k: int):
    """Per-iteration sketch key (a fresh S_k each iteration, as in Thm 2)."""
    return key.fold_in(k)


# Per-slice guardian status codes (DESIGN.md §15), int8, ordered by severity
# so that runs aggregate with a plain maximum.
STATUS_OK = 0           # certified: est_r <= tol before the budget ran out
STATUS_MAXITER = 1      # budget exhausted without certifying
STATUS_QUARANTINED = 2  # divergence detected; rolled back


def adaptive_masked_loop(iterates: Dict[str, torch.Tensor],
                         fit: Callable, step: Callable, tol: float, k0: int,
                         budget: int, batch: Tuple[int, ...],
                         divergence_factor: float = 10.0):
    """The §11 certify-then-freeze loop, with the §15 quarantine.

    For k in [k0, k0 + budget), while some slice is not done:

      aux, alpha, est_r = fit(iterates, k)     # reads the certificate
      done |= est_r <= tol                     # certify BEFORE updating
      new = step(iterates, aux, alpha)         # one iteration
      iterates = where(~done, new, iterates)   # frozen slices: bitwise

    A slice whose est_r goes non-finite or exceeds ``divergence_factor``
    times its best so far is QUARANTINED: rolled back to the iterate its
    best est_r was measured on and withdrawn.  Certification wins ties.
    The reference's ``lax.while_loop`` becomes a Python loop that stops
    when every slice is done; reading ``done.all()`` is its one host
    synchronization per iteration.

    Returns (iterates, used, status): the final iterates, the int32
    per-slice count of applied updates and the int8 STATUS_* codes.
    """
    names = tuple(iterates)
    dev = iterates[names[0]].device
    cur = dict(iterates)
    snap = dict(iterates)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    used = torch.zeros(batch, dtype=torch.int32, device=dev)
    best = torch.full(batch, float("inf"), dtype=torch.float32, device=dev)
    status = torch.zeros(batch, dtype=torch.int8, device=dev)
    for k in range(k0, k0 + budget):
        if k > k0 and bool(done.all()):
            break
        aux, a, est = fit(cur, k)
        certified = est <= tol                 # NaN est never certifies
        diverged = ~torch.isfinite(est) | (est > divergence_factor * best)
        quarantine = diverged & ~certified & ~done
        done = done | certified | quarantine
        active = ~done
        improved = est < best                  # NaN compares False
        keep = (improved & active)[..., None, None]
        new = step(cur, aux, a)
        mask = active[..., None, None]
        qmask = quarantine[..., None, None]
        used = used + active.to(torch.int32)
        best = torch.where(improved & active, est, best)
        status = torch.where(quarantine,
                             torch.full_like(status, STATUS_QUARANTINED),
                             status)
        for n in names:
            # snapshot BEFORE rollback: the best est_r was measured on the
            # pre-step iterate
            snap[n] = torch.where(keep, cur[n], snap[n])
            cur[n] = torch.where(qmask, snap[n],
                                 torch.where(mask, new[n], cur[n]))
    status = torch.where(done, status,
                         torch.full_like(status, STATUS_MAXITER))
    return cur, used, status


def resolve_alpha(k: int, R: torch.Tensor, apoly: poly.AlphaPoly,
                  cfg: PrismConfig, key,
                  n_real: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha_k per the config: warm iterations pin alpha = u (paper Sec. C),
    later iterations fit via the sketched objective."""
    lo, hi = cfg.bounds
    if k < cfg.warm_alpha_iters:
        return torch.full(R.shape[:-2], hi, dtype=torch.float32,
                          device=R.device)
    if key is not None:
        key = alpha_schedule_key(key, k)
    return fit_alpha(R, apoly, lo, hi, key=key, sketch_dim=cfg.sketch_dim,
                     use_kernels=cfg.use_kernels, n_real=n_real,
                     vmem_budget=cfg.vmem_budget)
