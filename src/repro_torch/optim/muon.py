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
axes).update`` does; the step's sketch
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

Async refresh plane (DESIGN.md §12): with ``precond_async`` the polar
chains never run inside ``step``.  Every matrix leaf carries an active
"ortho" (served every step) and a pending "ortho_p" twin (with
"iters_p"/"status_p" under telemetry), plus the drift proxy "dnorm"
(the momentum's accumulated movement) over "rnorm" (its norm at the last
dispatch).  ``refresh(key)`` recomputes the twins from the STORED
momentum (``bucketing.polar_refresh``, views in the reference's slot
order) and resets the drift proxy; ``base.AsyncPrecondService``
dispatches it, and the step swaps the twins in once ``count >=
pending_at + precond_swap_delay`` (``base.swap_pending``).

Sharding (DESIGN.md §8): under an activation-sharding context whose mesh
has a data axis larger than 1, ``polar_bucketed`` and ``polar_refresh``
partition each bucket's slices over the ranks and all-gather the polars
(``bucketing.shard_over_batch``); every rank then holds the same state.
With ``muon_local_reshard`` a bucket built only from layer stacks splits
its slices over the model axis and its rows over the data axis instead
(``bucketing.polar_local_rows``, DESIGN.md §4).

Sharded parameters (``shardings``: name -> ``launch.sharding.Sharding``,
a sharded model's layout; ``base.Blocks``): the moments are blocks like
their parameter; each matrix leaf's nesterov view is gathered whole
(``sharding.gather_full``, kind "opt") before it enters its bucket, and
the update applies its rank's block.  The AdamW branch is elementwise on
the blocks.  "ortho" and "ortho_p" are held as their
``precond_cache_sharding`` blocks (the leading layer dim over model, the
rows over data, as the reference lays them out): a refresh keeps its
block of the whole polar it applies, and a stale or async step gathers
each leaf's whole cache (kind "cache") just before applying it, one
leaf at a time.  Under the §12 plane
the refresh gathers the stored momentum blocks into whole views, the
drift proxy's norms are the whole moment's (block sums of squares
reduced over the world, kind "drift"), so every rank reads the same
drift, and the service takes its verdict over the world
(``base.AsyncPrecondService``); the swap stays a local select between
blocks of one layout.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.config import OptimizerConfig, torch_dtype
from repro_torch.core import matfn
from repro_torch.launch import sharding
from repro_torch.optim import base, bucketing


def _tree_key(name: str):
    """The sort key of a dotted name in ``jax.tree``'s order: dict keys as
    strings, list indices (the hybrid's ``tail.10``) as integers."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in name.split("."))


def leaf_order(names):
    """Each name's index in the reference's leaf order: ``jax.tree``
    flattens the nested parameter dict with its keys sorted at every
    level and a list's items by index, i.e. the names sorted by their
    dotted parts, integer parts as integers (``_tree_key``).  Per-leaf
    sketch keys fold in this index, so that a leaf draws the sketch the
    reference draws for it."""
    order = sorted(range(len(names)), key=lambda i: _tree_key(names[i]))
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
    (+ "tier", "ortho", "iters", "status" and the refresh plane's
    "ortho_p", "iters_p", "status_p", "dnorm", "rnorm") for matrix
    leaves, "mom"/"nu" for the others; under ``precond_async`` the
    optimizer also carries the root ``pending_at`` (``base.init_pending``).
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 cfg: OptimizerConfig, axes: Dict[str, tuple],
                 shardings: Optional[Dict[str, "sharding.Sharding"]] = None):
        named = list(named_params)
        super().__init__([p for _, p in named], defaults={})
        self.cfg = cfg
        self.axes = [tuple(axes[n]) for n, _ in named]
        self.leaf_idx = leaf_order([n for n, _ in named])
        self.blocks = base.Blocks(named, shardings)
        self.count = 0
        if cfg.precond_async:
            base.init_pending(self)
        for i, ((_, p), a) in enumerate(zip(named, self.axes)):
            self.state[p] = self._init_state(i, p, a)

    def _matrix(self, a: tuple, shape: tuple) -> bool:
        return base.is_matrix_param(a, tuple(shape),
                                    allow_embed=self.cfg.lowrank_rank > 0)

    def _init_state(self, i: int, p: torch.Tensor, a: tuple) -> Dict:
        cfg = self.cfg
        full = self.blocks.full_shapes[i]
        mom = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if not self._matrix(a, full):
            self.blocks.like_param(i, "mom", "nu")
            return {"mom": mom, "nu": torch.zeros_like(mom)}
        self.blocks.like_param(i, "mom")
        st = {"mom": mom}
        vshape = tuple(base.to_matrix_view(
            torch.empty(full, device="meta"), a)[0].shape)
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
            keys = ("ortho", "ortho_p") if cfg.precond_async else ("ortho",)
            st["ortho"] = torch.zeros(self.blocks.cache(i, keys, vshape),
                                      dtype=torch_dtype(cfg.cache_dtype),
                                      device=p.device)
        if cfg.precond_async:
            st["ortho_p"] = torch.zeros_like(st["ortho"])
            st["dnorm"] = torch.zeros((), dtype=torch.float32,
                                      device=p.device)
            st["rnorm"] = torch.zeros_like(st["dnorm"])
            if cfg.matfn_telemetry:
                st["iters_p"] = torch.zeros_like(st["iters"])
                st["status_p"] = torch.zeros_like(st["status"])
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
        blocks = self.blocks
        views, metas, idx, moved = [], [], [], []
        # pass 1: momentum everywhere; AdamW leaves finish immediately,
        # matrix leaves only queue their nesterov momentum view
        for i, (p, a) in enumerate(zip(params, self.axes)):
            g = (p.grad.float() if p.grad is not None
                 else torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device))
            st = self.state[p]
            if self._matrix(a, blocks.full_shapes[i]):
                mom = cfg.momentum * st["mom"] + g
                if cfg.precond_async:
                    # drift proxy (§12): the momentum's movement since
                    # the last dispatch; the view is not needed, only
                    # its layout
                    moved.append(torch.sum(torch.square(mom - st["mom"])))
                    M, meta = base.to_matrix_view(
                        torch.empty(blocks.full_shapes[i], device="meta"), a)
                else:
                    gm = g + cfg.momentum * mom  # nesterov
                    M, meta = base.to_matrix_view(
                        blocks.whole(gm, i, "mom", kind="opt"), a)
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
        if cfg.precond_async:
            # the moment's norms over the world: every rank reads the same
            for st, sq in zip(states, blocks.world_sums(moved, idx)):
                st["dnorm"] = st["dnorm"] + torch.sqrt(sq)
            # §12 steady state: never a polar here; the active cache is
            # served, or the pending twins once their swap is due
            keys = ("ortho", "iters", "status") if cfg.matfn_telemetry \
                else ("ortho",)
            base.swap_pending(self, [(st, k) for st in states for k in keys])
            polars = its = sts = None
        elif cfg.precond_every > 1:
            if refresh is None:
                refresh = self.count % cfg.precond_every == 0
            if refresh:
                polars, its, sts = self._orthogonalize(views, idx, key)
                cache = torch_dtype(cfg.cache_dtype)
                polars = [O.to(cache) for O in polars]
                for st, O, i in zip(states, polars, idx):
                    st["ortho"] = blocks.block(O, i, "ortho")
            else:
                polars = its = sts = None
        else:
            polars, its, sts = self._orthogonalize(views, idx, key)
        if its is not None:
            for st, it, s in zip(states, its, sts):
                st["iters"], st["status"] = it, s
        # pass 2: aspect-scale, un-view, apply.  Without a fresh polar
        # (a stale or async step) one leaf's cache is gathered whole at a
        # time and dropped after its update
        for j, (meta, i) in enumerate(zip(metas, idx)):
            p = params[i]
            O = (blocks.whole(states[j]["ortho"], i, "ortho")
                 if polars is None else polars[j])
            scale = math.sqrt(max(1.0, O.shape[-2] / O.shape[-1]))
            # scaled after the cut: no second whole-view temporary
            upd = blocks.block(base.from_matrix_view(O, meta), i,
                               "mom") * scale
            del O
            p32 = p.float() * (1.0 - lr * cfg.weight_decay) - lr * upd
            p.copy_(p32.to(p.dtype))
        self.count += 1

    # ------------------------------------------------------ refresh plane

    def refresh_inputs(self):
        """The tensors ``pending_twins`` reads: each matrix leaf's stored
        momentum."""
        return [st["mom"] for st in (self.state[p] for p in
                                     self.param_groups[0]["params"])
                if "ortho_p" in st]

    def pending_twins(self, key):
        """The §12 refresh's pending buffers, one partial dict per
        parameter: the polar of every matrix leaf's STORED momentum (not
        the nesterov view a blocking refresh would take), in
        ``cache_dtype``, with its telemetry twins.  The views are built
        in the reference's slot order (``leaf_order``), so that bucket
        entries and per-view keys (``polar_refresh``) are the
        reference's.  A zero momentum (the bootstrap, before any update)
        serves a zero polar, not the 0/0 of the alpha fit.  On sharded
        parameters the momentum blocks are gathered whole (kind "opt")
        and each twin is this rank's cache block of the whole polar."""
        cfg = self.cfg
        params = self.param_groups[0]["params"]
        blocks = self.blocks
        order = sorted((i for i, p in enumerate(params)
                        if "ortho_p" in self.state[p]),
                       key=self.leaf_idx.__getitem__)
        views = [base.to_matrix_view(blocks.whole(
            self.state[params[i]]["mom"], i, "mom", kind="opt"),
            self.axes[i])[0] for i in order]
        parts = [{} for _ in params]
        if not views:
            return parts
        outs, its, sts = bucketing.polar_refresh(views, cfg, key)
        cache = torch_dtype(cfg.cache_dtype)
        for j, i in enumerate(order):
            nrm = torch.sqrt(torch.sum(torch.square(views[j]), dim=(-2, -1),
                                       keepdim=True))
            O = torch.where(nrm > 0, outs[j], torch.zeros_like(outs[j]))
            parts[i] = {"ortho_p": blocks.block(O.to(cache), i, "ortho_p")}
            if its is not None:
                parts[i]["iters_p"], parts[i]["status_p"] = its[j], sts[j]
        return parts

    def drift_baseline(self):
        """The drift proxy a refresh resets, one partial dict per
        parameter: "rnorm", the norm of the momentum the twins are
        computed from (the whole moment's, on sharded parameters), and a
        zero "dnorm"."""
        params = self.param_groups[0]["params"]
        idx = [i for i, p in enumerate(params) if "ortho_p" in self.state[p]]
        sums = self.blocks.world_sums(
            [torch.sum(torch.square(self.state[params[i]]["mom"]))
             for i in idx], idx)
        parts = [{} for _ in params]
        for i, sq in zip(idx, sums):
            parts[i] = {"rnorm": torch.sqrt(sq),
                        "dnorm": torch.zeros_like(self.state[params[i]]
                                                  ["dnorm"])}
        return parts

    def refresh(self, key):
        """The reference's ``refresh(state, key)``: the pending twins and
        the drift reset, one partial dict per parameter, for
        ``base.install_pending``."""
        return base.merge_partials(self.pending_twins(key),
                                   self.drift_baseline())
