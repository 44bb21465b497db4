"""Muon with PRISM orthogonalization (paper Sec. 6.2; counterpart of
``repro/optim/muon.py``).

Matrix-shaped hidden weights: nesterov momentum -> polar factor of the
momentum -> aspect-ratio-scaled update.  Everything else (embeddings, the
LM head, norms) takes AdamW with a scaled lr, as in standard Muon
practice.  Orthogonalization is shape-bucketed (``bucketing``): same-shape
momentum matrices stack into one [B, m, n] polar call per bucket.

``step(key=...)`` does what the reference's ``make_muon(cfg, axes).update``
does for ``precond_every=1`` without telemetry; the step's sketch key
(``core.rng.Key``) seeds the fitted PRISM iterations, bucket ``bi``
drawing from ``key.fold_in(bi)``; with ``bucketed=False`` each matrix
leaf draws from ``key.fold_in(i)``, ``i`` its index in the reference's
leaf order (``leaf_order``), not its place in ``named_params``.
Momentum and the applied update stay fp32 whatever ``matfn_dtype`` is.
The staleness cache, the async refresh plane, adaptive ``matfn_tol``
telemetry and the lowrank tier are ported with later slices and raise
here.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.core import matfn
from repro_torch.optim import base, bucketing


def _check_supported(cfg: OptimizerConfig) -> None:
    unported = {
        "precond_every > 1 (staleness cache, ROADMAP.md Queue 1 item 8)":
            cfg.precond_every > 1,
        "precond_async (refresh plane, ROADMAP.md Queue 1 item 8)":
            cfg.precond_async,
        "matfn_tol (Muon's adaptive-stopping telemetry state, "
        "ROADMAP.md Queue 1 item 3)":
            cfg.matfn_tol is not None,
        "lowrank_rank (lowrank tier, ROADMAP.md Queue 1 item 7)":
            cfg.lowrank_rank > 0,
        "muon_local_reshard (sharding, ROADMAP.md Queue 1 item 11)":
            cfg.muon_local_reshard,
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError("Muon options not ported yet: "
                                  + "; ".join(missing))


def leaf_order(names):
    """Each name's index in the reference's leaf order: ``jax.tree``
    flattens the nested parameter dict with its keys sorted at every
    level, i.e. the names sorted by ``tuple(name.split("."))``.  Per-leaf
    sketch keys fold in this index, so that a leaf draws the sketch the
    reference draws for it."""
    order = sorted(range(len(names)),
                   key=lambda i: tuple(names[i].split(".")))
    rank = [0] * len(names)
    for r, i in enumerate(order):
        rank[i] = r
    return rank


class Muon(torch.optim.Optimizer):
    """Muon over named parameters with their logical axes.

    ``named_params``: (name, tensor) pairs, e.g. ``model.named_parameters()``;
    ``axes``: name -> logical-axis tuple (``Model.logical_axes()``), which
    decides the matrix view of every parameter.  Hyperparameters live in
    ``cfg``; gradients are read from ``.grad`` as fp32.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 cfg: OptimizerConfig, axes: Dict[str, tuple]):
        _check_supported(cfg)
        named = list(named_params)
        super().__init__([p for _, p in named], defaults={})
        self.cfg = cfg
        self.axes = [tuple(axes[n]) for n, _ in named]
        self.leaf_idx = leaf_order([n for n, _ in named])
        self.count = 0

    def _matrix(self, a: tuple, p: torch.Tensor) -> bool:
        return base.is_matrix_param(a, tuple(p.shape))

    def _orthogonalize(self, views, idx, key):
        cfg = self.cfg
        if cfg.bucketed:
            return bucketing.polar_bucketed(views, cfg, key)
        return [matfn.polar(M, method=cfg.matfn_method,
                            cfg=cfg.resolved_prism,
                            key=(key.fold_in(self.leaf_idx[i])
                                 if key is not None else None))
                for M, i in zip(views, idx)]

    @torch.no_grad()
    def step(self, closure=None, key=None):
        """One Muon update from the parameters' ``.grad``.  ``key`` is the
        step's sketch key; None fits alpha from exact traces (only the
        fitted PRISM iterations read it)."""
        if closure is not None:
            raise ValueError("Muon.step takes no closure")
        cfg = self.cfg
        lr = cfg.learning_rate
        params = self.param_groups[0]["params"]
        views, metas, idx = [], [], []
        # pass 1: momentum everywhere; AdamW leaves finish immediately,
        # matrix leaves only queue their nesterov momentum view
        for i, (p, a) in enumerate(zip(params, self.axes)):
            g = (p.grad.float() if p.grad is not None
                 else torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device))
            st = self.state[p]
            if "mom" not in st:
                st["mom"] = torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                if not self._matrix(a, p):
                    st["nu"] = torch.zeros_like(st["mom"])
            if self._matrix(a, p):
                mom = cfg.momentum * st["mom"] + g
                gm = g + cfg.momentum * mom  # nesterov
                M, meta = base.to_matrix_view(gm, a)
                views.append(M)
                metas.append(meta)
                idx.append(i)
                st["mom"] = mom
            else:
                b1, b2 = cfg.beta1, cfg.beta2
                mom = b1 * st["mom"] + (1 - b1) * g
                nu = b2 * st["nu"] + (1 - b2) * torch.square(g)
                t = float(self.count + 1)
                mhat = mom / (1 - b1 ** t)
                vhat = nu / (1 - b2 ** t)
                alr = lr * cfg.adamw_lr_scale
                p32 = p.float() * (1.0 - alr * cfg.weight_decay) \
                    - alr * mhat / (torch.sqrt(vhat) + cfg.eps)
                st["mom"], st["nu"] = mom, nu
                p.copy_(p32.to(p.dtype))
        # pass 2: orthogonalize (one batched call per shape bucket),
        # aspect-scale, un-view, apply
        for O, meta, i in zip(self._orthogonalize(views, idx, key), metas,
                              idx):
            p = params[i]
            scale = math.sqrt(max(1.0, O.shape[-2] / O.shape[-1]))
            upd = base.from_matrix_view(O * scale, meta)
            p32 = p.float() * (1.0 - lr * cfg.weight_decay) - lr * upd
            p.copy_(p32.to(p.dtype))
        self.count += 1
