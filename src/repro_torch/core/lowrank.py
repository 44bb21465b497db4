"""Low-rank sketched orthogonalization (DESIGN.md §14; counterpart of
``repro/core/lowrank.py``).

The cubic polar path costs O(m n^2) a Newton-Schulz iteration, so the
views that dominate a large model (embedding and LM-head tables,
m ~ 10^5) would bypass the PRISM engine.  Muon's convergence survives
orthogonalizing only the dominant rank-k subspace of the momentum (He et
al., arXiv 2509.11983); this module computes that at O(mnl) with
l = k + oversample << min(m, n):

  1. rangefinder: Y = M @ Omega with a Gaussian test matrix Omega in
     R^{n x l} (``sketch.gaussian_sketch``, one per bucket through the
     key), refined by power iterations Y <- M (M^T Y), and orthonormalized
     into Q in R^{m x l} by the engine's own polar (Gram side l);
  2. subspace fit: B = Q^T M in R^{l x n} runs the same polar;
  3. lift: O = Q @ polar(B), one [m, l] x [l, n] GEMM.

The products go through ``newton_schulz._mm`` (K1 with
``cfg.use_kernels``), the orthonormalizations through ``matfn.polar``
(K2 and K1 on the grid tier, or the fused tier where the [m, l] / [l, n]
slice fits).  K1 takes contiguous row-major operands, so the transposes
(a wide view, M^T, Q^T) are materialized.  Zero pad rows or columns of M
stay zero through sketch, projection and lift, and the Gram residuals
live on the l side, which is never padded: no ``n_real`` correction is
needed.  Everything broadcasts over leading batch dims.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import PrismConfig
from repro_torch.core import sketch as sk
from repro_torch.core.newton_schulz import _fro, _mm
from repro_torch.core.rng import Key


def _gaussian_test_matrix(key, n: int, l: int, dtype,
                          device) -> torch.Tensor:
    """Omega in R^{n x l}: the ``sketch.gaussian_sketch`` Gaussian,
    transposed, drawn on ``device``.  The 1/sqrt(l) scaling is irrelevant
    (Q re-orthonormalizes) but keeps Y's magnitude tame."""
    return sk.gaussian_sketch(key, l, n, dtype=dtype, device=device).T


def rangefinder(M: torch.Tensor, l: int, key,
                cfg: Optional[PrismConfig] = None, method: str = "prism",
                power_iters: int = 1) -> torch.Tensor:
    """Sketched orthonormal range basis Q [..., m, l] of M [..., m, n].

    Y = M Omega captures the dominant column space; ``power_iters``
    rounds of Y <- M (M^T Y) sharpen it to the (2q+1)-th power of the
    spectrum.  The orthonormalization is the engine's polar (fitted when
    ``method="prism"``), not a QR: batched, kernel-tiered, and exact on a
    rank-deficient Y (a partial isometry spanning range(M)).
    """
    cfg = PrismConfig() if cfg is None else cfg
    from repro_torch.core import matfn

    n = M.shape[-1]
    Om = _gaussian_test_matrix(key.fold_in(0), n, l, M.dtype, M.device)
    Y = _mm(M, Om, cfg.use_kernels)
    Mt = M.transpose(-1, -2)
    for _ in range(power_iters):
        # per-slice Frobenius rescale between products: keeps the power
        # iterates away from bf16 overflow without touching directions
        Y = Y / torch.clamp(_fro(Y).to(Y.dtype), min=1e-30)
        Y = _mm(M, _mm(Mt, Y, cfg.use_kernels), cfg.use_kernels)
    return matfn.polar(Y, method=method, cfg=cfg, key=key.fold_in(1))


def polar_lowrank(M: torch.Tensor, rank: int, oversample: int,
                  cfg: Optional[PrismConfig] = None, key=None,
                  method: str = "prism", power_iters: int = 1,
                  return_iters: bool = False, return_status: bool = False):
    """Rank-l orthogonalization O ~ U_l V_l^T of M [..., m, n] (§14).

    l = min(rank + oversample, min(m, n)).  A wide M is processed through
    its transpose (polar(M^T) = polar(M)^T), so the rangefinder always
    sketches the long side.  ``return_iters`` / ``return_status`` surface
    the per-slice telemetry of the SUBSPACE chain (the rangefinder's
    polar is auxiliary).  ``key`` defaults to ``Key(0)``.
    """
    cfg = PrismConfig() if cfg is None else cfg
    from repro_torch.core import matfn

    if key is None:
        key = Key(0)
    transpose = M.shape[-2] < M.shape[-1]
    X = M.transpose(-1, -2) if transpose else M
    n = X.shape[-1]
    l = min(rank + oversample, n)
    Q = rangefinder(X, l, key.fold_in(0), cfg=cfg, method=method,
                    power_iters=power_iters)
    B = _mm(Q.transpose(-1, -2), X, cfg.use_kernels)  # [..., l, n]
    P = matfn.polar(B, method=method, cfg=cfg, key=key.fold_in(1),
                    return_iters=return_iters, return_status=return_status)
    if return_iters or return_status:
        P, *aux = P
    O = _mm(Q, P, cfg.use_kernels)
    O = O.transpose(-1, -2) if transpose else O
    if return_iters or return_status:
        return (O, *aux)
    return O


def svd_topk(M: torch.Tensor, k: int) -> torch.Tensor:
    """Oracle: the exact top-k truncated orthogonalization U_k V_k^T (the
    target ``polar_lowrank`` approximates; tests and checks only)."""
    U, _, Vh = torch.linalg.svd(M.float(), full_matrices=False)
    return (U[..., :, :k] @ Vh[..., :k, :]).to(M.dtype)
