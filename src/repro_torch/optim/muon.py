"""Muon with PRISM orthogonalization (paper Sec. 6.2; counterpart of
``repro/optim/muon.py``).

Matrix-shaped hidden weights: nesterov momentum -> polar factor of the
momentum (``matfn_method``: prism | newton_schulz | polar_express | svd)
-> aspect-ratio-scaled update.  Everything else (embeddings, the LM head,
norms) takes AdamW with a scaled lr, as in standard Muon practice —
unless the lowrank tier is on (``lowrank_rank > 0``, DESIGN.md §14): Muon
then claims the vocab tables too, and ``bucketing.polar_bucketed``
routes each view too large or too rectangular for the cubic path through
``core/lowrank.py``; every matrix leaf then carries the int32 "tier" its
view shape resolves to (``bucketing.TIER_CODES``).
Orthogonalization is shape-bucketed (``bucketing``): same-shape momentum
matrices stack into one [B, m, n] polar call per bucket.

``step(key=, refresh=)`` does what the reference's ``make_muon(cfg,
axes).update`` does without the async refresh plane; the step's sketch
key (``core.rng.Key``) seeds the fitted PRISM iterations, bucket ``bi``
drawing from ``key.fold_in(bi)``; with ``bucketed=False`` each matrix
leaf draws from ``key.fold_in(i)``, ``i`` its index in the reference's
leaf order (``leaf_order``), not its place in ``named_params``.
Momentum and the applied update stay fp32 whatever ``matfn_dtype`` is.

Staleness cache (DESIGN.md §8): with ``precond_every = K > 1`` every
matrix leaf carries its orthogonalized view "ortho" in ``cache_dtype``,
refreshed when ``count % K == 0`` (decided on the host: ``count`` is a
host int) and served in between; a Python-bool ``refresh`` forces the
choice.  A step that does not refresh runs no matrix function at all.
Every step applies the cache-rounded polar, refresh or not, as the
reference does.

Telemetry (DESIGN.md §11/§15): with an adaptive ``matfn_tol`` and the
prism method (``cfg.matfn_telemetry``) every matrix leaf carries the
realized iteration counts "iters" (int32) and the guardian codes "status"
(int8) of its view's slices, refreshed with the polars and carried
through stale steps untouched.

The async refresh plane and ``muon_local_reshard`` raise here (ROADMAP.md
Queue 1 items 8b, 11).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.config import OptimizerConfig, torch_dtype
from repro_torch.core import matfn
from repro_torch.optim import base, bucketing


def _check_supported(cfg: OptimizerConfig) -> None:
    unported = {
        "precond_async (refresh plane, ROADMAP.md Queue 1 item 8b)":
            cfg.precond_async,
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
    ``cfg``; gradients are read from ``.grad`` as fp32.  The state of
    every parameter is created here, with the reference's keys: "mom"
    (+ "tier", "ortho", "iters", "status") for matrix leaves, "mom"/"nu"
    for the others.
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
        for (_, p), a in zip(named, self.axes):
            self.state[p] = self._init_state(p, a)

    def _matrix(self, a: tuple, p: torch.Tensor) -> bool:
        return base.is_matrix_param(a, tuple(p.shape),
                                    allow_embed=self.cfg.lowrank_rank > 0)

    def _init_state(self, p: torch.Tensor, a: tuple) -> Dict:
        cfg = self.cfg
        mom = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if not self._matrix(a, p):
            return {"mom": mom, "nu": torch.zeros_like(mom)}
        st = {"mom": mom}
        vshape = tuple(base.to_matrix_view(
            torch.empty(p.shape, device="meta"), a)[0].shape)
        if cfg.matfn_telemetry:
            st["iters"] = torch.zeros(vshape[:-2], dtype=torch.int32,
                                      device=p.device)
            st["status"] = torch.zeros(vshape[:-2], dtype=torch.int8,
                                       device=p.device)
        if cfg.lowrank_rank > 0:
            st["tier"] = torch.full((), bucketing.TIER_CODES[
                bucketing.resolve_tier(cfg, vshape[-2:])],
                dtype=torch.int32, device=p.device)
        if cfg.precond_every > 1:
            st["ortho"] = torch.zeros(vshape,
                                      dtype=torch_dtype(cfg.cache_dtype),
                                      device=p.device)
        return st

    def _orthogonalize(self, views, idx, key):
        """(polars, iters, statuses) of the views; the last two None
        unless ``cfg.matfn_telemetry``."""
        cfg = self.cfg
        tele = cfg.matfn_telemetry
        if cfg.bucketed:
            if tele:
                return bucketing.polar_bucketed(views, cfg, key,
                                                with_iters=True)
            return bucketing.polar_bucketed(views, cfg, key), None, None
        kw = dict(return_iters=True, return_status=True) if tele else {}
        outs = [matfn.polar(M, method=cfg.matfn_method,
                            cfg=cfg.resolved_prism,
                            key=(key.fold_in(self.leaf_idx[i])
                                 if key is not None else None), **kw)
                for M, i in zip(views, idx)]
        if tele:
            return tuple(list(t) for t in zip(*outs))
        return outs, None, None

    @torch.no_grad()
    def step(self, closure=None, key=None, refresh=None):
        """One Muon update from the parameters' ``.grad``.  ``key`` is the
        step's sketch key; None fits alpha from exact traces (only the
        fitted PRISM iterations read it).  ``refresh`` (a bool) overrides
        the staleness schedule of ``precond_every > 1``."""
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
                c1, c2 = base.adam_bias_corrections(b1, b2, self.count)
                alr = lr * cfg.adamw_lr_scale
                p32 = p.float() * (1.0 - alr * cfg.weight_decay) \
                    - alr * (mom / c1) / (torch.sqrt(nu / c2) + cfg.eps)
                st["mom"], st["nu"] = mom, nu
                p.copy_(p32.to(p.dtype))
        # orthogonalize (one batched call per shape bucket), behind the
        # staleness schedule when precond_every > 1
        states = [self.state[params[i]] for i in idx]
        if cfg.precond_every > 1:
            if refresh is None:
                refresh = self.count % cfg.precond_every == 0
            if refresh:
                polars, its, sts = self._orthogonalize(views, idx, key)
                cache = torch_dtype(cfg.cache_dtype)
                polars = [O.to(cache) for O in polars]
                for st, O in zip(states, polars):
                    st["ortho"] = O
            else:
                polars = [st["ortho"] for st in states]
                its = sts = None
        else:
            polars, its, sts = self._orthogonalize(views, idx, key)
        if its is not None:
            for st, it, s in zip(states, its, sts):
                st["iters"], st["status"] = it, s
        # pass 2: aspect-scale, un-view, apply
        for O, meta, i in zip(polars, metas, idx):
            p = params[i]
            scale = math.sqrt(max(1.0, O.shape[-2] / O.shape[-1]))
            upd = base.from_matrix_view(O * scale, meta)
            p32 = p.float() * (1.0 - lr * cfg.weight_decay) - lr * upd
            p.copy_(p32.to(p.dtype))
        self.count += 1
