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


def _residual(X):
    """Polar residual with the fused kernels' accumulation order: the
    I - X^T X epilogue runs on the fp32 accumulator, rounding ONCE to the
    compute dtype.  (The sign and coupled sqrt families come with
    Shampoo, ROADMAP.md Queue 1 item 6.)"""
    G = _mm32(X.transpose(-1, -2), X)
    eye = torch.eye(G.shape[-1], dtype=torch.float32, device=X.device)
    return (eye - G).to(X.dtype)


def _horner(X, R, alpha32, coeffs: Sequence[float]):
    """fp32 Horner accumulator of X g_d(R; a): each dot's operand rounds to
    the compute dtype, the carried f_j * X epilogues never do."""
    x32 = X.float()
    acc = alpha32 * x32
    for j in range(len(coeffs) - 1, -1, -1):
        acc = _mm32(acc.to(X.dtype), R) + coeffs[j] * x32
    return acc.to(X.dtype)


def warm_tail(X, alphas: Sequence[float], *, coeffs: Sequence[float]):
    """Fused constant-alpha multi-iteration oracle of the polar family (one
    residual + one Horner application per alpha, fused accumulation order
    throughout)."""
    for a in alphas:
        a32 = torch.tensor(a, dtype=torch.float32, device=X.device)
        X = _horner(X, _residual(X), a32, coeffs)
    return X
