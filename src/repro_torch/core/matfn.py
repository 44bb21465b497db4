"""Public matrix-function API (counterpart of ``repro/core/matfn.py``).

Ported so far: ``polar`` with the Newton-Schulz family — ``prism`` (warm
and fitted iterations, adaptive ``tol``) and ``newton_schulz`` (classical
Taylor alpha).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import PrismConfig
from repro_torch.core import newton_schulz as _ns


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
    if method == "polar_express":
        raise NotImplementedError(
            "polar_express is ported after the Shampoo families "
            "(ROADMAP.md Queue 1 item 3)")
    raise NotImplementedError(
        f"polar method {method!r} is not ported (ROADMAP.md Queue 1)")
