"""Optimizer utilities shared by the port's optimizers (counterpart of
``repro/optim/base.py``): global-norm clipping, the matrix views Muon and
Shampoo precondition, and the refresh period.

The reference's functional ``Optimizer(init, update, refresh)`` contract
becomes ``torch.optim.Optimizer`` subclasses (``muon.Muon``,
``shampoo.Shampoo``): ``init`` is the lazily created per-parameter
``state``, ``update`` is ``step()``.  The
async refresh plane, ``skip_nonfinite`` and the pending-buffer helpers
come with later slices (ROADMAP.md Queue 1 items 4 and 8).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32."""
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t.float()))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale grads (as fp32) so their global norm is at most ``max_norm``.

    Guarded (§15): a zero set keeps scale 1 instead of dividing by zero,
    and a NON-FINITE global norm passes the gradients through UNSCALED, so
    one inf entry does not turn into an all-zero or all-NaN step.  Returns
    (clipped grads, raw global norm)."""
    gn = global_norm(grads)
    scale = torch.where(torch.isfinite(gn),
                        torch.clamp(max_norm / torch.clamp(gn, min=1e-12),
                                    max=1.0),
                        torch.ones_like(gn))
    return [g.float() * scale for g in grads], gn


def resolve_refresh_period(cfg, name: Optional[str] = None) -> int:
    """Effective preconditioner refresh period K of one optimizer: Muon
    refreshes every ``precond_every`` steps; Shampoo also honours its
    legacy ``precondition_every``, so its period is the max of the two.
    ``name`` overrides ``cfg.name``."""
    name = cfg.name if name is None else name
    k = max(1, int(cfg.precond_every))
    if name == "shampoo":
        k = max(k, int(cfg.precondition_every))
    return k


def is_matrix_param(path_axes: tuple, shape: tuple,
                    allow_embed: bool = False) -> bool:
    """Muon applies to hidden weight matrices: >=2D, both matrix dims
    reasonably large, and not an embedding/vocab/codebook table
    (``allow_embed`` lifts the table exclusion)."""
    if not allow_embed and any(a in ("vocab", "codebooks")
                               for a in path_axes if a):
        return False
    dims = matrix_view_dims(path_axes, shape)
    if dims is None:
        return False
    m, n = dims
    return min(m, n) >= 16


def matrix_view_dims(path_axes: tuple, shape: tuple) -> Optional[tuple]:
    """(rows, cols) of the Muon matrix view; None if not matrix-like.

    The 'embed' logical axis marks the contraction side: the matrix is
    (embed-dim) x (product of remaining non-batch dims).  Leading 'layers'
    / 'experts' axes are batch.  Without an 'embed' tag, the last two dims
    form the matrix (generic case).
    """
    axes = tuple(path_axes)
    batch = {"layers", "experts"}
    non_batch = [(i, a) for i, a in enumerate(axes) if a not in batch]
    if len(non_batch) < 2:
        return None
    idxs = [i for i, _ in non_batch]
    names = [a for _, a in non_batch]
    if "embed" in names:
        e = idxs[names.index("embed")]
        m = shape[e]
        n = 1
        for i in idxs:
            if i != e:
                n *= shape[i]
        return (m, n)
    m = shape[idxs[-2]]
    n = shape[idxs[-1]]
    for i in idxs[:-2]:
        m *= shape[i]
    return (m, n)


def to_matrix_view(p: torch.Tensor, path_axes: tuple):
    """Reshape p to [..batch.., m, n] with 'embed' as the row dim (possibly
    transposed into place).  Returns (view, meta); inverse via
    ``from_matrix_view``."""
    axes = tuple(path_axes)
    batch = {"layers", "experts"}
    batch_idx = [i for i, a in enumerate(axes) if a in batch]
    other_idx = [i for i, a in enumerate(axes) if a not in batch]
    names = [axes[i] for i in other_idx]
    lead = tuple(p.shape[i] for i in batch_idx)
    if "embed" in names:
        e = other_idx[names.index("embed")]
        rest = [i for i in other_idx if i != e]
        perm = batch_idx + [e] + rest
        q = p.permute(perm)
        n = 1
        for i in rest:
            n *= p.shape[i]
        return q.reshape(lead + (p.shape[e], n)), (perm, tuple(q.shape))
    rest = tuple(p.shape[i] for i in other_idx)
    perm = batch_idx + other_idx
    q = p.permute(perm)
    mm = 1
    for d in rest[:-1]:
        mm *= d
    return q.reshape(lead + (mm, rest[-1])), (perm, tuple(q.shape))


def from_matrix_view(q: torch.Tensor, meta) -> torch.Tensor:
    perm, mid_shape = meta
    q = q.reshape(mid_shape)
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return q.permute(inv)
