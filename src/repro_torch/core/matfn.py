"""Public matrix-function API (counterpart of ``repro/core/matfn.py``).

Ported so far, ``method`` per function:

  polar:     prism | newton_schulz
  sqrtm:     prism | newton_schulz | eigh
  inv_sqrtm: same as sqrtm (the coupled iteration's Y output)
  signm:     prism | newton_schulz | eigh
  inv_proot: eigh

"prism" adapts alpha per iteration from the sketched spectrum (warm and
fitted iterations, adaptive ``cfg.tol``); "newton_schulz" uses the
classical Taylor alpha; "eigh" is the LAPACK baseline, pinned fp32
(``torch.linalg.eigh``).  The other methods raise ``NotImplementedError``
naming their ROADMAP.md item.  Entry points construct a fresh
``PrismConfig()`` per call when none is given.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import PrismConfig
from repro_torch.core import newton_schulz as _ns

_UNPORTED = {
    "polar_express": "polar_express is ported with ROADMAP.md Queue 1 "
                     "item 3",
    "svd": "the svd method is ported with ROADMAP.md Queue 1 item 3",
    "newton": "DB-Newton (core/newton.py) is ported with ROADMAP.md "
              "Queue 1 item 6",
    "newton_classical": "DB-Newton (core/newton.py) is ported with "
                        "ROADMAP.md Queue 1 item 6",
    "inverse_newton": "core/inverse_newton.py is ported with ROADMAP.md "
                      "Queue 1 item 6",
    "prism_chebyshev": "core/chebyshev.py is ported with ROADMAP.md Queue 1 "
                       "item 6",
    "chebyshev": "core/chebyshev.py is ported with ROADMAP.md Queue 1 "
                 "item 6",
}


def _unported(fn: str, method: str):
    msg = _UNPORTED.get(method)
    if msg is None:
        msg = f"method {method!r} of {fn} is not ported (ROADMAP.md Queue 1)"
    raise NotImplementedError(f"{fn}: {msg}")


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
    if method in ("prism", "newton_schulz"):
        return _ns.polar(A, cfg=cfg, method=method, iters=iters, key=key,
                         **kw)
    _unported("polar", method)


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
    if method in ("prism", "newton_schulz"):
        return _ns.sqrtm(A, cfg=cfg, method=method, iters=iters, key=key,
                         **kw)
    _unported("sqrtm", method)


def inv_sqrtm(A: torch.Tensor, method: str = "prism", **kw):
    """A^{-1/2} for symmetric PSD A (the coupled iteration's Y output).
    With ``return_info``/``return_iters``/``return_status`` the telemetry
    rides along: (A^{-1/2}[, info][, iters_used][, status])."""
    if method == "inverse_newton":
        _unported("inv_sqrtm", method)
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
    if method in ("prism", "newton_schulz"):
        return _ns.signm(A, cfg=cfg, method=method, iters=iters, key=key,
                         **kw)
    _unported("signm", method)


def inv_proot(A: torch.Tensor, p: int, method: str = "prism",
              iters: Optional[int] = None, key=None, **kw):
    """A^{-1/p} for SPD A (Shampoo's eigh baseline).  The iterative
    methods (prism and classical inverse Newton) are ported with
    ROADMAP.md Queue 1 item 6."""
    if method == "eigh":
        kw.pop("tol", None)  # no iterations to stop early
        w, V, Vt = _eigh(A)
        w = torch.clamp(w, min=1e-30)
        out = ((V * (w ** (-1.0 / p))[..., None, :]) @ Vt).to(A.dtype)
        return _telemetry_shim(out, A, kw, method)
    raise NotImplementedError(
        f"inv_proot: method {method!r} (core/inverse_newton.py) is ported "
        f"with ROADMAP.md Queue 1 item 6")
