"""Plain PyTorch versions of the kernels (the correctness contracts).

Each function is the mathematical definition with no tiling: the CPU path
of every wrapper in ``ops.py``, the oracle of the CPU tests, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.  Counterpart
of ``repro/kernels/ref.py``.

Accumulation semantics (DESIGN.md §9): products accumulate in fp32 whatever
the operand dtype (bf16 operands go through ``.float()`` products, which
are exact), the epilogues (C-add, alpha*I) run on the fp32 accumulator, and
only the tensor that leaves the function rounds once to the operand dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _mm32(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A.float(), B.float())


def matmul_add(A, B, C=None, *, alpha: float = 1.0, beta: float = 0.0):
    """D = alpha * A @ B + beta * C."""
    out = alpha * _mm32(A, B)
    if C is not None and beta != 0.0:
        out = out + beta * C.float()
    return out.to(A.dtype)


def gram(X, *, alpha: float = 1.0, beta: float = -1.0):
    """R = alpha * I + beta * X^T X (symmetric)."""
    n = X.shape[-1]
    G = _mm32(X.transpose(-1, -2), X)
    eye = torch.eye(n, dtype=torch.float32, device=X.device)
    return (alpha * eye + beta * G).to(X.dtype)


def _residual(X, Y=None, *, family: str = "polar"):
    """Family residual with the fused kernels' accumulation order: the
    I - <product> epilogue (and the sqrt re-symmetrization) runs on the
    fp32 accumulator, rounding ONCE to the compute dtype.

      polar  I - X^T X       sign  I - X X       sqrt  sym(I - Y X)
    """
    if family == "polar":
        G = _mm32(X.transpose(-1, -2), X)
    elif family == "sign":
        G = _mm32(X, X)
    elif family == "sqrt":
        G = _mm32(Y, X)
    else:
        raise ValueError(f"unknown family {family!r}")
    eye = torch.eye(G.shape[-1], dtype=torch.float32, device=X.device)
    r32 = eye - G
    if family == "sqrt":
        r32 = 0.5 * (r32 + r32.transpose(-1, -2))
    return r32.to(X.dtype)


def _horner(X, R, alpha32, coeffs: Sequence[float], side: str = "right"):
    """fp32 Horner accumulator of X g_d(R; a) (``side="right"``) or
    g_d(R; a) X (``"left"``): each dot's operand rounds to the compute
    dtype, the carried f_j * X epilogues never do."""
    x32 = X.float()
    acc = alpha32 * x32
    for j in range(len(coeffs) - 1, -1, -1):
        lo = acc.to(X.dtype)
        prod = _mm32(lo, R) if side == "right" else _mm32(R, lo)
        acc = prod + coeffs[j] * x32
    return acc.to(X.dtype)


def warm_tail(X, alphas: Sequence[float], *, coeffs: Sequence[float],
              family: str = "polar", Y=None):
    """Fused constant-alpha multi-iteration oracle (one residual + one
    Horner application per alpha, fused accumulation order throughout).
    The coupled sqrt family updates X on the right and Y on the left from
    the same R and returns (X, Y)."""
    for a in alphas:
        R = _residual(X, Y, family=family)
        a32 = torch.tensor(a, dtype=torch.float32, device=X.device)
        if family == "sqrt":
            X, Y = (_horner(X, R, a32, coeffs, "right"),
                    _horner(Y, R, a32, coeffs, "left"))
        else:
            X = _horner(X, R, a32, coeffs, "right")
    return (X, Y) if family == "sqrt" else X


def _chain(R, St, max_power: int, V=None):
    """The sketched power chain V_i = R V_{i-1}, V_0 = St (or ``V``), on
    R [..., n, n] and St [n, p] in R's dtype: each trace reduces fp32 St
    against the fp32 ACCUMULATOR of R @ V, before V' rounds to R's dtype
    (DESIGN.md §9).  Returns (fp32 traces [..., max_power], last V)."""
    St32 = St.float()
    if V is None:
        V = St.expand(R.shape[:-2] + St.shape)
    traces = []
    for _ in range(max_power):
        Vacc = _mm32(R, V)
        traces.append(torch.sum(St32 * Vacc, dim=(-2, -1)))
        V = Vacc.to(R.dtype)
    return torch.stack(traces, dim=-1), V


def sketch_traces(R, S, max_power: int):
    """t_i = tr(S R^i S^T), i = 0..max_power (fp32); t_0 is sketch-only."""
    St = S.transpose(-1, -2).to(R.dtype)
    St32 = St.float()
    t0 = torch.sum(St32 * St32) * torch.ones(
        R.shape[:-2], dtype=torch.float32, device=R.device)
    ts, _ = _chain(R, St, max_power)
    return torch.cat([t0[..., None], ts], dim=-1)


def sketch_step(R, V, St):
    """One chain power (the plain version of K4): V' = R @ V rounded to
    R's dtype, and t' = sum(St * (R @ V)) reduced from the fp32
    accumulator.  R [..., n, n], V [..., n, p], St [n, p]."""
    ts, Vn = _chain(R, St, 1, V=V)
    return Vn, ts[..., 0]


def residual_chain(X, S, max_power: int, *, family: str = "polar", Y=None):
    """(R, t): the family residual rounded once to X's dtype, and the
    sketched chain on that ROUNDED R, fp32 traces [..., max_power] for
    powers 1..max_power (the plain version of K6)."""
    R = _residual(X, Y, family=family)
    ts, _ = _chain(R, S.transpose(-1, -2).to(R.dtype), max_power)
    return R, ts


def apply_g(X, R, alpha, *, coeffs: Sequence[float], Y=None):
    """X g_d(R; alpha) (and, coupled, g_d(R; alpha) Y) with the fused
    accumulation order (the plain version of K7): the fp32 alpha
    multiplies the fp32 operand inside the fp32 Horner accumulator and is
    never rounded first.  ``alpha``: a float or an fp32 tensor over X's
    leading dims.  Returns X' or, with ``Y``, (X', Y')."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=X.device)
    if a.dim():
        a = a[..., None, None]
    out = _horner(X, R, a, coeffs, "right")
    if Y is None:
        return out
    return out, _horner(Y, R, a, coeffs, "left")
