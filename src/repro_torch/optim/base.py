"""Optimizer utilities shared by the port's optimizers (counterpart of
``repro/optim/base.py``): global-norm clipping, the matrix views Muon and
Shampoo precondition, the refresh period, Adam's bias corrections and the
§15 skip-step guard.

The reference's functional ``Optimizer(init, update, refresh)`` contract
becomes ``torch.optim.Optimizer`` subclasses (``muon.Muon``,
``shampoo.Shampoo``, ``adamw.AdamW``): ``init`` is the per-parameter
``state`` each creates in its constructor, ``update`` is
``step(key=, refresh=)``, and the reference's ``state["count"]`` is the
optimizer's ``count``, a host int (a device tensor under
``skip_nonfinite``).  The async refresh plane and the pending-buffer
helpers come with a later slice (ROADMAP.md Queue 1 item 8b).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

#: the per-parameter state keys of the §12 async refresh plane's pending
#: twins: checkpoints drop them (``checkpoint.save(drop=)``) and a
#: restore keeps the target's own value.  Nothing in the port sets them
#: until the refresh plane is ported (ROADMAP.md Queue 1 item 8b).
PENDING_STATE_KEYS = frozenset({
    "ortho_p", "Linv_p", "Rinv_p",
    "iters_p", "Linv_iters_p", "Rinv_iters_p",
    "status_p", "Linv_status_p", "Rinv_status_p",
})


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


def adam_bias_corrections(b1: float, b2: float, count):
    """(1 - b1**t, 1 - b2**t) for t = count + 1, Adam's bias corrections.

    A host ``count`` gives Python floats; a device ``count`` (under
    ``skip_nonfinite``) gives fp32 device scalars, so nothing is read back
    to the host."""
    if isinstance(count, torch.Tensor):
        t = (count + 1).float()
        return 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
    t = float(count + 1)
    return 1 - b1 ** t, 1 - b2 ** t


class SkipNonfinite:
    """§15 skip-step guard around an optimizer (``skip_nonfinite``).

    A non-finite gradient would contaminate the momentum and EMA
    accumulators for good (0 * NaN is NaN).  Each ``step`` therefore
    snapshots the parameters and the whole state, lets the inner
    optimizer propose its update, and commits every buffer with
    ``torch.where(ok, new, old)``, where ``ok`` is ONE fused finiteness
    flag on the device over the gradients and the proposed parameters.
    Nothing is read back to the host: the inner step makes the same
    launches either way, and no branch waits on the device.

    ``bad_steps`` (a device int32) advances on a skipped step; ``count``
    (the inner optimizer's, made a device int32 here so that it can roll
    back) does not.  The refresh schedule of a period K > 1 cannot read
    that device count without a synchronization, so the guard keeps a
    host clock of its own (the steps taken) and passes the inner step an
    explicit ``refresh = clock % K == 0`` when the caller gives none;
    after a skipped step it runs one step ahead of ``count``.  The
    Trainer always passes ``refresh``.  Everything else (``state``,
    ``param_groups``, ``cfg``) is the inner optimizer's.
    """

    def __init__(self, opt):
        self.opt = opt
        dev = opt.param_groups[0]["params"][0].device
        self.bad_steps = torch.zeros((), dtype=torch.int32, device=dev)
        self.clock = 0
        self.count = opt.count

    def __getattr__(self, name):
        if name == "opt":  # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.opt, name)

    @property
    def count(self):
        return self.opt.count

    @count.setter
    def count(self, value) -> None:
        """Set the step count (a restore): the host clock follows it."""
        self.clock = int(value)
        dev = self.opt.param_groups[0]["params"][0].device
        self.opt.count = torch.full((), self.clock, dtype=torch.int32,
                                    device=dev)

    @torch.no_grad()
    def step(self, closure=None, key=None, refresh=None):
        if closure is not None:
            raise ValueError("SkipNonfinite.step takes no closure")
        opt = self.opt
        params = opt.param_groups[0]["params"]
        period = resolve_refresh_period(opt.cfg)
        if refresh is None and period > 1:
            refresh = self.clock % period == 0
        old_p = [p.detach().clone() for p in params]
        old_s = [{k: v.clone() for k, v in opt.state[p].items()}
                 for p in params]
        old_count = opt.count.clone()
        opt.step(key=key, refresh=refresh)
        checks = [p.grad for p in params if p.grad is not None] + params
        ok = torch.stack([torch.isfinite(t).all() for t in checks]).all()
        for p, old in zip(params, old_p):
            p.copy_(torch.where(ok, p, old))
        for p, old in zip(params, old_s):
            st = opt.state[p]
            for k, v in old.items():
                st[k] = torch.where(ok, st[k], v)
        opt.count = torch.where(ok, opt.count, old_count)
        self.bad_steps = self.bad_steps + (~ok).to(torch.int32)
        self.clock += 1


def skip_nonfinite(opt) -> SkipNonfinite:
    """Wrap ``opt`` in the §15 skip-step guard (``SkipNonfinite``);
    ``make_optimizer`` does so when ``cfg.skip_nonfinite``."""
    return SkipNonfinite(opt)


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
