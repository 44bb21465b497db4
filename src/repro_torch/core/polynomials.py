"""Polynomial algebra of the PRISM meta-algorithm (counterpart of
``repro/core/polynomials.py``).

PRISM replaces the degree-d Taylor update with
``g_d(xi; alpha) = f_{d-1}(xi) + alpha xi^d`` and picks alpha by
minimizing the (sketched) Frobenius norm of the next residual

    h(x; alpha) = P_0(x) + alpha P_1(x) + ... + alpha^s P_s(x),
    m(alpha) = tr(S h(R; alpha)^2 S^T),

a degree-2s polynomial in alpha whose coefficients are fixed linear
combinations of the sketched power traces t_i = tr(S R^i S^T).  The
fixed maps are numpy tables built once per polynomial; the constrained
minimizers are batched torch ops in fp32 that never read a value back to
the host (no ``.item()``, no branch on a tensor), so the fit runs between
kernel launches without a synchronization.

Ported so far: the Newton-Schulz residual (polar).  The inverse-Newton and
Chebyshev residuals come with Shampoo (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch


def taylor_inv_sqrt(d: int) -> np.ndarray:
    """Coefficients (ascending) of the degree-d Taylor poly of (1-x)^{-1/2}.

    c_j = (2j-1)!! / (2j)!! = prod_{i<=j} (2i-1)/(2i);  c_0 = 1.
    """
    c = np.ones(d + 1, dtype=np.float64)
    for j in range(1, d + 1):
        c[j] = c[j - 1] * (2 * j - 1) / (2 * j)
    return c


def poly_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.convolve(a, b)


def poly_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = max(len(a), len(b))
    out = np.zeros(n, dtype=np.float64)
    out[: len(a)] += a
    out[: len(b)] += b
    return out


def poly_scale(a: np.ndarray, s: float) -> np.ndarray:
    return np.asarray(a, dtype=np.float64) * s


def monomial(k: int) -> np.ndarray:
    m = np.zeros(k + 1, dtype=np.float64)
    m[k] = 1.0
    return m


# ---------------------------------------------------------------------------
# Residual polynomials  h(x; alpha) = sum_j alpha^j P_j(x)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlphaPoly:
    """h(x; alpha) = sum_j alpha^j polys[j](x); coefficient vectors ascending."""

    polys: Tuple[Tuple[float, ...], ...]

    @staticmethod
    def make(polys: Sequence[np.ndarray]) -> "AlphaPoly":
        return AlphaPoly(tuple(tuple(float(v) for v in p) for p in polys))

    @property
    def alpha_degree(self) -> int:
        return len(self.polys) - 1

    @property
    def x_degree(self) -> int:
        return max(len(p) for p in self.polys) - 1

    def np_polys(self) -> Tuple[np.ndarray, ...]:
        return tuple(np.asarray(p, dtype=np.float64) for p in self.polys)

    def eval(self, x, alpha):
        """Elementwise h(x; alpha) for floats, arrays or tensors."""
        out = 0.0
        for j, p in enumerate(self.np_polys()):
            px = 0.0
            for c in p[::-1]:
                px = px * x + float(c)
            out = out + (alpha ** j) * px
        return out


@functools.lru_cache(maxsize=None)
def newton_schulz_residual(d: int) -> AlphaPoly:
    """Residual poly of PRISM Newton-Schulz (polar).

    h(x, alpha) = 1 - (1 - x) * g_d(x; alpha)^2 with
    g_d(x; alpha) = f_{d-1}(x) + alpha x^d.  Expanding in alpha:
      P_0 = 1 - (1-x) f_{d-1}^2
      P_1 = -2 (1-x) x^d f_{d-1}
      P_2 = -(1-x) x^{2d}
    """
    f = taylor_inv_sqrt(d - 1)
    one_minus_x = np.array([1.0, -1.0])
    p0 = poly_add(np.array([1.0]),
                  poly_scale(poly_mul(one_minus_x, poly_mul(f, f)), -1.0))
    p1 = poly_scale(poly_mul(one_minus_x, poly_mul(monomial(d), f)), -2.0)
    p2 = poly_scale(poly_mul(one_minus_x, monomial(2 * d)), -1.0)
    return AlphaPoly.make([p0, p1, p2])


# ---------------------------------------------------------------------------
# m(alpha) coefficients as a fixed linear map of power traces
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def trace_weight_matrix(apoly: AlphaPoly) -> np.ndarray:
    """W such that  m_coeffs[k] = sum_i W[k, i] * t_i,  t_i = tr(S R^i S^T).

    m(alpha) = sum_{p,q} alpha^{p+q} tr(S P_p(R) P_q(R) S^T), and
    P_p(R) P_q(R) expands over powers of R by coefficient convolution.
    Shape: [2s+1, 2*x_degree+1].
    """
    polys = apoly.np_polys()
    s = apoly.alpha_degree
    max_pow = 2 * apoly.x_degree
    W = np.zeros((2 * s + 1, max_pow + 1), dtype=np.float64)
    for p in range(s + 1):
        for q in range(s + 1):
            conv = poly_mul(polys[p], polys[q])
            W[p + q, : len(conv)] += conv
    return W


def max_trace_power(apoly: AlphaPoly) -> int:
    return 2 * apoly.x_degree


def apply_trace_weights(W: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """coeffs[..., k] = sum_i W[k, i] * t[..., i] in fp32.

    The weights (rounded to fp32, as the reference rounds its W) enter as
    Python scalars, so the map needs no host-to-device copy of W; zero
    weights are skipped.
    """
    cols = t.unbind(-1)
    out = []
    for row in np.asarray(W, np.float32):
        acc = None
        for i, w in enumerate(row):
            if w == 0.0:
                continue
            term = cols[i] * float(w)
            acc = term if acc is None else acc + term
        out.append(torch.zeros_like(cols[0]) if acc is None else acc)
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Batched constrained polynomial minimization on [l, u] (fp32, no host sync)
# ---------------------------------------------------------------------------


def _polyval_asc(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_k coeffs[..., k] x^k with broadcasting over leading dims."""
    out = torch.zeros_like(x)
    for k in range(coeffs.shape[-1] - 1, -1, -1):
        out = out * x + coeffs[..., k]
    return out


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d = 0, branchless.

    Returns three candidates (copies of the single real root when the
    other two are complex).  Degenerate leading coefficients are handled
    by the caller's extra quadratic candidates.
    """
    eps = 1e-30
    a = torch.where(torch.abs(a) < eps, eps, a)
    # depressed cubic t^3 + p t + q,  x = t - b/(3a)
    p = (3 * a * c - b * b) / (3 * a * a)
    q = (2 * b ** 3 - 9 * a * b * c + 27 * a * a * d) / (27 * a ** 3)
    shift = -b / (3 * a)
    disc = (q / 2) ** 2 + (p / 3) ** 3
    # one real root (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r_single = _cbrt(-q / 2 + sq) + _cbrt(-q / 2 - sq) + shift
    # three real roots (disc <= 0): trigonometric method
    pm = torch.clamp(p, max=-eps)  # p < 0 in this branch
    m = 2 * torch.sqrt(-pm / 3)
    den = pm * m  # can underflow to -0.0 in fp32 (triple root at 0)
    den = torch.where(torch.abs(den) < 1e-20, -1e-20, den)
    arg = torch.clamp(3 * q / den, -1.0, 1.0)
    theta = torch.arccos(arg) / 3
    two_pi_3 = 2 * math.pi / 3
    r0 = m * torch.cos(theta) + shift
    r1 = m * torch.cos(theta - two_pi_3) + shift
    r2 = m * torch.cos(theta - 2 * two_pi_3) + shift
    single = disc > 0
    return (torch.where(single, r_single, r0),
            torch.where(single, r_single, r1),
            torch.where(single, r_single, r2))


def minimize_quartic(coeffs: torch.Tensor, lo: float, hi: float
                     ) -> torch.Tensor:
    """argmin over [lo, hi] of the quartic sum_k coeffs[..., k] a^k.

    Candidates in the reference's order (the endpoints, the three cubic
    stationary points, the two quadratic and the linear fallback roots),
    clipped to [lo, hi]; ``argmin`` takes the first minimum, as
    ``jnp.argmin`` does.
    """
    c1 = coeffs[..., 1]
    c2 = coeffs[..., 2]
    c3 = coeffs[..., 3] if coeffs.shape[-1] > 3 else torch.zeros_like(c1)
    c4 = coeffs[..., 4] if coeffs.shape[-1] > 4 else torch.zeros_like(c1)
    # m'(a) = c1 + 2 c2 a + 3 c3 a^2 + 4 c4 a^3
    r0, r1, r2 = cubic_roots(4 * c4, 3 * c3, 2 * c2, c1)
    # quadratic fallback (c4 ~ 0): 3 c3 a^2 + 2 c2 a + c1 = 0
    qa, qb, qc = 3 * c3, 2 * c2, c1
    qdisc = torch.clamp(qb * qb - 4 * qa * qc, min=0.0)
    qden = torch.where(torch.abs(qa) < 1e-30, 1e-30, 2 * qa)
    q0 = (-qb + torch.sqrt(qdisc)) / qden
    q1 = (-qb - torch.sqrt(qdisc)) / qden
    # linear fallback (c3 ~ c4 ~ 0)
    lden = torch.where(torch.abs(qb) < 1e-30, 1e-30, qb)
    lin = -qc / lden
    lo_a = torch.full_like(c1, lo)
    hi_a = torch.full_like(c1, hi)
    cands = torch.stack([lo_a, hi_a, r0, r1, r2, q0, q1, lin], dim=-1)
    cands = torch.clamp(cands, lo, hi)
    cands = torch.where(torch.isfinite(cands), cands, lo)
    vals = _polyval_asc(coeffs[..., None, :], cands)
    best = torch.argmin(vals, dim=-1, keepdim=True)
    return torch.gather(cands, -1, best)[..., 0]


def minimize_poly_grid(coeffs: torch.Tensor, lo: float, hi: float,
                       num: int = 257, newton_iters: int = 2
                       ) -> torch.Tensor:
    """argmin of a polynomial of any degree on [lo, hi]: a dense grid scan
    plus a few Newton refinements on m'."""
    grid = torch.linspace(lo, hi, num, dtype=coeffs.dtype,
                          device=coeffs.device)
    vals = _polyval_asc(coeffs[..., None, :], grid)
    best = torch.argmin(vals, dim=-1)
    a = grid[best]
    K = coeffs.shape[-1]
    # derivative coefficients (ascending): dm[k] = (k+1) coeffs[k+1]
    dm = coeffs[..., 1:] * torch.arange(1, K, dtype=coeffs.dtype,
                                        device=coeffs.device)
    ddm = (dm[..., 1:] * torch.arange(1, K - 1, dtype=coeffs.dtype,
                                      device=coeffs.device)
           if K > 2 else None)
    for _ in range(newton_iters):
        if ddm is None:
            break
        g = _polyval_asc(dm.expand(a.shape + (dm.shape[-1],)), a)
        h = _polyval_asc(ddm.expand(a.shape + (ddm.shape[-1],)), a)
        safe = torch.where(torch.abs(h) < 1e-30, 1e-30, h)
        step = torch.where(h > 0, g / safe, 0.0)
        a = torch.clamp(a - step, lo, hi)
    return a


def minimize_alpha_poly(coeffs: torch.Tensor, lo: float, hi: float
                        ) -> torch.Tensor:
    """Closed form for degree <= 4, the grid otherwise."""
    if coeffs.shape[-1] <= 5:
        pad = 5 - coeffs.shape[-1]
        if pad:
            coeffs = torch.cat([coeffs, coeffs.new_zeros(
                coeffs.shape[:-1] + (pad,))], dim=-1)
        return minimize_quartic(coeffs, lo, hi)
    return minimize_poly_grid(coeffs, lo, hi)
