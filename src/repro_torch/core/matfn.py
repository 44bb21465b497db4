"""Public matrix-function API (counterpart of ``repro/core/matfn.py``).

``method`` per function:

  polar:     prism | newton_schulz | polar_express | svd
  sqrtm:     prism | newton_schulz | polar_express | newton (DB) |
             newton_classical | eigh
  inv_sqrtm: same as sqrtm (the coupled Y output) + inverse_newton
  signm:     prism | newton_schulz | eigh
  inv:       prism_chebyshev | chebyshev | inverse_newton | solve
  inv_proot: prism | inverse_newton (any other non-eigh method runs
             classical inverse Newton) | eigh

"prism" adapts alpha per iteration from the sketched spectrum (warm and
fitted iterations, adaptive ``cfg.tol`` or ``tol=``); "newton_schulz" uses
the classical Taylor alpha; "polar_express" is the fixed minimax schedule
of Amsel et al. (``core/polar_express.py``), run at ``cfg.dtype``; "svd",
"eigh" and "solve" are the LAPACK baselines, pinned fp32, as is
DB-Newton's Cholesky by default.  The Newton-Schulz family (polar, sqrtm,
signm) runs through the kernels with ``cfg.use_kernels``; inverse Newton,
Chebyshev and DB-Newton run plain PyTorch products, as the reference runs
them outside its kernels.  A method the reference does not have raises
``ValueError`` in the Newton-Schulz family.  Entry points construct a
fresh ``PrismConfig()`` per call when none is given.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import PrismConfig
from repro_torch.core import chebyshev as _cheb
from repro_torch.core import inverse_newton as _invnewton
from repro_torch.core import newton as _newton
from repro_torch.core import newton_schulz as _ns
from repro_torch.core import polar_express as _pe


def _telemetry_shim(out, A, kw, method: str):
    """Telemetry contract of the methods without fitted iterations (the
    LAPACK baselines): ``return_iters`` appends int32 zeros and
    ``return_status`` int8 zeros (they certify nothing), and
    ``return_info`` — a trajectory they never produce — raises.  Pops the
    telemetry keys from ``kw``."""
    if kw.pop("return_info", False):
        raise ValueError(f"return_info is not supported by "
                         f"method={method!r} (no iteration trajectory)")
    ri = kw.pop("return_iters", False)
    rs = kw.pop("return_status", False)
    res = (out,)
    lead = tuple(A.shape[:-2])
    if ri:
        res = res + (torch.zeros(lead, dtype=torch.int32, device=A.device),)
    if rs:
        res = res + (torch.zeros(lead, dtype=torch.int8, device=A.device),)
    return res if len(res) > 1 else out


def _run_fixed_schedule(fn, A, kw):
    """Run a fixed-schedule (fit-free) family that supports
    ``return_info`` but not ``return_iters``/``return_status``
    (polar_express, DB-Newton): pops those keys and appends int32 / int8
    zeros flat after the family's (out[, info]) result, keeping the
    documented (out[, info][, iters][, status]) shape."""
    ri = kw.pop("return_iters", False)
    rs = kw.pop("return_status", False)
    res = fn(**kw)
    if not (ri or rs):
        return res
    if not kw.get("return_info"):
        res = (res,)
    lead = tuple(A.shape[:-2])
    if ri:
        res = res + (torch.zeros(lead, dtype=torch.int32, device=A.device),)
    if rs:
        res = res + (torch.zeros(lead, dtype=torch.int8, device=A.device),)
    return res


def _eigh(A: torch.Tensor):
    """(w, V, V^T) of the fp32 symmetric eigendecomposition of A."""
    w, V = torch.linalg.eigh(A.float())
    return w, V, V.transpose(-1, -2)


def polar(A: torch.Tensor, method: str = "prism",
          cfg: Optional[PrismConfig] = None,
          iters: Optional[int] = None, key=None, **kw):
    """Polar factor U V^T (orthogonalization) of A [..., m, n].

    ``key`` is the sketch key of the fitted PRISM iterations
    (``core.rng.Key``); kw passes through to ``newton_schulz.polar``:
    ``return_info``, ``return_iters``, ``return_status``, ``n_real``.
    ``cfg.tol`` enables adaptive early stopping.
    """
    if method == "svd":
        U, _, Vh = torch.linalg.svd(A.float(), full_matrices=False)
        return _telemetry_shim((U @ Vh).to(A.dtype), A, kw, method)
    if method == "polar_express":
        kw.setdefault("dtype", (PrismConfig() if cfg is None else cfg).dtype)
        return _run_fixed_schedule(
            lambda **k: _pe.polar(A, iters=iters or 8, **k), A, kw)
    return _ns.polar(A, cfg=cfg, method=method, iters=iters, key=key, **kw)


def sqrtm(A: torch.Tensor, method: str = "prism",
          cfg: Optional[PrismConfig] = None,
          iters: Optional[int] = None, key=None, **kw):
    """(A^{1/2}, A^{-1/2}) for symmetric PSD A [..., n, n].

    kw passes through to ``newton_schulz.sqrtm`` (``return_info``,
    ``return_iters``, ``return_status``); ``cfg.tol`` freezes both coupled
    iterates of a slice on certification.
    """
    if method == "eigh":
        w, V, Vt = _eigh(A)
        s = torch.sqrt(torch.clamp(w, min=0.0))
        si = torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-30),
                         torch.zeros_like(s))
        out = (((V * s[..., None, :]) @ Vt).to(A.dtype),
               ((V * si[..., None, :]) @ Vt).to(A.dtype))
        return _telemetry_shim(out, A, kw, method)
    if method == "polar_express":
        kw.setdefault("dtype", (PrismConfig() if cfg is None else cfg).dtype)
        return _run_fixed_schedule(
            lambda **k: _pe.sqrtm(A, iters=iters or 8, **k), A, kw)
    if method in ("newton", "newton_classical"):
        return _run_fixed_schedule(
            lambda **k: _newton.sqrtm(
                A, iters=iters or 12,
                method="prism" if method == "newton" else "newton", **k),
            A, kw)
    return _ns.sqrtm(A, cfg=cfg, method=method, iters=iters, key=key, **kw)


def inv_sqrtm(A: torch.Tensor, method: str = "prism", **kw):
    """A^{-1/2} for symmetric PSD A (the coupled iteration's Y output).
    With ``return_info``/``return_iters``/``return_status`` the telemetry
    rides along: (A^{-1/2}[, info][, iters_used][, status])."""
    if method == "inverse_newton":
        return _invnewton.inv_proot(A, p=2, **kw)
    res = sqrtm(A, method=method, **kw)
    if kw.get("return_info") or kw.get("return_iters") \
            or kw.get("return_status"):
        return (res[0][1],) + tuple(res[1:])
    return res[1]


def signm(A: torch.Tensor, method: str = "prism",
          cfg: Optional[PrismConfig] = None,
          iters: Optional[int] = None, key=None, **kw):
    """sign(A) for A [..., n, n] with A^2 symmetric.

    kw passes through to ``newton_schulz.signm`` (``return_info``,
    ``return_iters``, ``return_status``); ``cfg.tol`` enables adaptive
    early stopping.
    """
    if method == "eigh":
        w, V, Vt = _eigh(A)
        out = ((V * torch.sign(w)[..., None, :]) @ Vt).to(A.dtype)
        return _telemetry_shim(out, A, kw, method)
    return _ns.signm(A, cfg=cfg, method=method, iters=iters, key=key, **kw)


def inv(A: torch.Tensor, method: str = "prism_chebyshev",
        iters: Optional[int] = None, key=None, **kw):
    """A^{-1} for full-rank square A [..., n, n].

    kw passes through to the Chebyshev / inverse-Newton family: ``tol``
    (adaptive early stopping of the prism methods), ``return_info``,
    ``return_iters``, ``return_status``, ``dtype``, ``sketch_dim``,
    ``alpha_bounds``, ``divergence_factor``.
    """
    if method == "solve":
        kw.pop("tol", None)  # no iterations to stop early
        A32 = A.float()
        eye = torch.eye(A.shape[-1], dtype=torch.float32,
                        device=A.device).expand(A32.shape)
        return _telemetry_shim(torch.linalg.solve(A32, eye).to(A.dtype),
                               A, kw, method)
    if method == "inverse_newton":
        return _invnewton.inv_proot(A, p=1, iters=iters or 20, key=key, **kw)
    return _cheb.inv(A, iters=iters or 20,
                     method="prism" if method == "prism_chebyshev"
                     else "classical", key=key, **kw)


def inv_proot(A: torch.Tensor, p: int, method: str = "prism",
              iters: Optional[int] = None, key=None, **kw):
    """A^{-1/p} for SPD A [..., n, n].

    kw passes through to ``inverse_newton.inv_proot``: ``tol``,
    ``return_info``, ``return_iters``, ``return_status``, ``dtype``,
    ``sketch_dim``, ``alpha_bounds``, ``divergence_factor``.
    """
    if method == "eigh":
        kw.pop("tol", None)  # no iterations to stop early
        w, V, Vt = _eigh(A)
        w = torch.clamp(w, min=1e-30)
        out = ((V * (w ** (-1.0 / p))[..., None, :]) @ Vt).to(A.dtype)
        return _telemetry_shim(out, A, kw, method)
    return _invnewton.inv_proot(
        A, p=p, iters=iters or 20,
        method="prism" if method == "prism" else "classical", key=key, **kw)
