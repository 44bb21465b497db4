"""Shampoo with PRISM inverse p-th roots (paper Sec. 6.2; counterpart of
``repro/optim/shampoo.py``).

    W <- W - lr * L^{-1/p} G R^{-1/p}     (p = 2 by default)

with L/R the EMA Kronecker factors G G^T / G^T G of each matrix view.
``matfn_method`` selects how the inverse roots are computed, as in the
reference's ``_inv_root``: ``eigh`` (the classical baseline) at any p;
at p = 2 ``polar_express`` (its fixed schedule in coupled form),
``newton`` (PRISM DB-Newton, Cholesky-based, fp32) and otherwise the
coupled PRISM Newton-Schulz iteration (``matfn.sqrtm``'s Y output;
``newton_schulz`` falls through to it); at p != 2 every method but
``eigh`` runs PRISM coupled inverse Newton (``matfn.inv_proot``, plain
PyTorch products as in the reference).  A side longer than
``max_precond_dim`` falls back to a diagonal (AdaGrad) preconditioner.
Preconditioned updates are norm-grafted to the raw gradient norm, then
go through heavy-ball momentum and decoupled weight decay; leaves that
are not matrices take Adam.

The inverse roots of every matrix leaf's L and R factors — across leaves,
L before R in the reference's leaf order — stack into one [B, n, n] call
per distinct n (``bucketing.transform_bucketed``), bucket ``bi`` drawing
its sketches from the step's key folded with ``bi``; with
``bucketed=False`` each factor runs on its own, keyed by
``key.fold_in(i)`` (then ``.fold_in(1)`` for R) with ``i`` the leaf's
index in the reference's leaf order (``muon.leaf_order``).  They are
recomputed every ``base.resolve_refresh_period`` steps, a count kept on
the host (a Python-bool ``refresh`` forces the choice): a step that does
not refresh serves "Linv"/"Rinv" from the state and launches nothing.
Under a mesh with a data axis larger than 1 the buckets' slices are
partitioned over the ranks and the roots all-gathered (DESIGN.md §8).

Precision (DESIGN.md §9): the EMA factors and their eps-ridge stay fp32;
the inverse-root chains run at ``matfn_dtype`` with fp32 accumulation,
and the cached inverse roots are stored in ``cfg.cache_dtype``.

Telemetry (DESIGN.md §11/§15): with an adaptive ``matfn_tol`` and the
prism method (``cfg.matfn_telemetry``) each full-matrix side carries
"Linv_iters"/"Rinv_iters" (int32) and "Linv_status"/"Rinv_status" (int8)
per slice, refreshed with the inverse roots.

``step(key=, refresh=)`` does what the reference's ``make_shampoo(cfg,
axes).update`` does.

Async refresh plane (DESIGN.md §12): with ``precond_async`` no inverse
root runs inside ``step``.  Every cached side carries a pending twin
("Linv_p"/"Rinv_p", with the telemetry twins) and every matrix leaf
with one the joint drift proxy of its factors ("dnorm" over "rnorm");
``refresh(key)`` recomputes the twins from the STORED factors
(``_fresh_invs``, jobs in the reference's slot order) and
``base.swap_pending`` swaps them in, as in ``muon``.

Sharded parameters (``shardings``: name -> ``launch.sharding.Sharding``,
a sharded model's layout; ``base.Blocks``), as the reference under
GSPMD: each matrix leaf's gradient is gathered whole (kind "opt") before
its EMA factors, so "L"/"R"/"diagL"/"diagR" stay whole and equal on
every rank (the reference replicates them); the inverse roots run
through the §8 batch engine over data as above; the step preconditions
and grafts the whole view and keeps its rank's block of the result, to
which the momentum ("mom", a block like its parameter) and the update
apply.  "Linv"/"Rinv" and their twins are held as their
``precond_cache_sharding`` blocks: a refresh keeps its block of the
whole root it applies, and a stale or async step gathers each whole
root (kind "cache") just before applying it, one at a time.  The factors' drift proxy is whole already, so every
rank reads the same drift; the service takes its verdict over the world
(``base.AsyncPrecondService``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.config import OptimizerConfig, torch_dtype
from repro_torch.core import matfn
from repro_torch.launch import sharding
from repro_torch.optim import base, bucketing
from repro_torch.optim.muon import leaf_order

BETA2 = 0.999   # EMA decay of the Kronecker factors (the reference's)


def inv_root(A: torch.Tensor, p: int, cfg: OptimizerConfig, key,
             with_iters: bool = False):
    """A^{-1/p} per ``cfg.matfn_method`` for fp32 EMA factors A [..., n, n];
    ``with_iters`` appends the §11 ``iters_used`` and the §15 int8 status
    (data-dependent under an adaptive ``matfn_tol``; the fit-free
    baselines report zeros).

    The eps-ridge is applied to the fp32 factor BEFORE any cast: a bf16
    ridge would round eps away against trace-scale entries (§9)."""
    eps = cfg.shampoo_eps
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    Ad = A + eps * tr[..., None, None] * eye / n + eps * eye
    pc = cfg.resolved_prism
    m = cfg.matfn_method

    def plain(out):
        if not with_iters:
            return out
        lead = tuple(A.shape[:-2])
        return (out, torch.zeros(lead, dtype=torch.int32, device=A.device),
                torch.zeros(lead, dtype=torch.int8, device=A.device))

    if m == "eigh":
        return plain(matfn.inv_proot(Ad, p=p, method="eigh"))
    if m == "polar_express" and p == 2:
        return plain(matfn.sqrtm(Ad, method="polar_express",
                                 iters=pc.iterations, dtype=pc.dtype)[1])
    if m == "newton" and p == 2:
        # DB-Newton is Cholesky-based: pinned fp32 (DESIGN.md §9)
        return plain(matfn.sqrtm(Ad, method="newton",
                                 iters=pc.iterations)[1])
    if p == 2:
        if with_iters:
            (_, isq), it, st = matfn.sqrtm(Ad, method="prism", cfg=pc,
                                           key=key, iters=pc.iterations,
                                           return_iters=True,
                                           return_status=True)
            return isq, it, st
        return matfn.sqrtm(Ad, method="prism", cfg=pc, key=key,
                           iters=pc.iterations)[1]
    return matfn.inv_proot(Ad, p=p, method="prism", key=key,
                           iters=pc.iterations, dtype=pc.dtype, tol=pc.tol,
                           return_iters=with_iters, return_status=with_iters,
                           divergence_factor=pc.divergence_factor)


class Shampoo(torch.optim.Optimizer):
    """Shampoo over named parameters with their logical axes.

    ``named_params``: (name, tensor) pairs, e.g. ``model.named_parameters()``;
    ``axes``: name -> logical-axis tuple (``Model.logical_axes()``), which
    decides the matrix view of every parameter.  Hyperparameters live in
    ``cfg``; gradients are read from ``.grad`` as fp32.  The per-parameter
    state, created here, carries the reference's keys: "mom", "L"/"Linv"
    or "diagL", "R"/"Rinv" or "diagR" (+ the telemetry keys) for matrix
    leaves, "mom"/"nu" for the others; under ``precond_async`` also the
    refresh plane's twins ("Linv_p", "Rinv_p", their telemetry twins),
    "dnorm", "rnorm" and the root ``pending_at``.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 cfg: OptimizerConfig, axes: Dict[str, tuple],
                 p_root: int = 2,
                 shardings: Optional[Dict[str, "sharding.Sharding"]] = None):
        named = list(named_params)
        super().__init__([p for _, p in named], defaults={})
        self.cfg = cfg
        self.p_root = p_root
        self.axes = [tuple(axes[n]) for n, _ in named]
        self.leaf_idx = leaf_order([n for n, _ in named])
        self.blocks = base.Blocks(named, shardings)
        self.count = 0
        if cfg.precond_async:
            base.init_pending(self)
        for i, ((_, p), a) in enumerate(zip(named, self.axes)):
            self.state[p] = self._init_state(i, p, a)

    def _init_state(self, i: int, p: torch.Tensor, a: tuple) -> Dict:
        cfg = self.cfg
        full = self.blocks.full_shapes[i]
        mom = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if not base.is_matrix_param(a, full):
            self.blocks.like_param(i, "mom", "nu")
            return {"mom": mom, "nu": torch.zeros_like(mom)}
        self.blocks.like_param(i, "mom")
        M, _ = base.to_matrix_view(torch.empty(full, device="meta"), a)
        lead, (m, n) = tuple(M.shape[:-2]), tuple(M.shape[-2:])
        cache = torch_dtype(cfg.cache_dtype)
        st = {"mom": mom}
        for side, k in (("L", m), ("R", n)):
            if k <= cfg.max_precond_dim:
                st[side] = torch.zeros(lead + (k, k), dtype=torch.float32,
                                       device=p.device)
                name = side + "inv"
                keys = (name, name + "_p") if cfg.precond_async else (name,)
                st[name] = torch.zeros(
                    self.blocks.cache(i, keys, lead + (k, k)), dtype=cache,
                    device=p.device)
                if cfg.matfn_telemetry:
                    st[side + "inv_iters"] = torch.zeros(
                        lead, dtype=torch.int32, device=p.device)
                    st[side + "inv_status"] = torch.zeros(
                        lead, dtype=torch.int8, device=p.device)
            else:
                st["diag" + side] = torch.zeros(lead + (k,),
                                                dtype=torch.float32,
                                                device=p.device)
        if cfg.precond_async and ("L" in st or "R" in st):
            for k in [k for k in st if k.endswith("inv")
                      or k.endswith("_iters") or k.endswith("_status")]:
                st[k + "_p"] = torch.zeros_like(st[k])
            st["dnorm"] = torch.zeros((), dtype=torch.float32,
                                      device=p.device)
            st["rnorm"] = torch.zeros_like(st["dnorm"])
        return st

    def _fresh_invs(self, jobs, key):
        """(invs, iters, statuses) of the jobs' factors, the last two None
        unless ``cfg.matfn_telemetry``.  Bucketed: one batched call per
        shape bucket, keys folded by bucket index; per-leaf: one call a
        factor, keys folded by the leaf's reference index (and 1 for
        R)."""
        cfg = self.cfg
        cache = torch_dtype(cfg.cache_dtype)
        tele = cfg.matfn_telemetry

        def one(A, kk):
            if tele:
                inv, it, st = inv_root(A, self.p_root, cfg, kk,
                                       with_iters=True)
                return inv.to(cache), it, st
            return inv_root(A, self.p_root, cfg, kk).to(cache)

        if not cfg.bucketed:
            outs = []
            for i, name, A in jobs:
                kk = (key.fold_in(self.leaf_idx[i]) if key is not None
                      else None)
                if kk is not None and name == "Rinv":
                    kk = kk.fold_in(1)
                outs.append(one(A, kk))
            if tele:
                return tuple(list(t) for t in zip(*outs))
            return outs, None, None
        out = bucketing.transform_bucketed(
            [A for (_, _, A) in jobs],
            lambda st, b, bi: one(st, key.fold_in(bi)
                                  if key is not None else None),
            cfg=cfg, with_aux=2 if tele else 0)
        return out if tele else (out, None, None)

    @torch.no_grad()
    def step(self, closure=None, key=None, refresh=None):
        """One Shampoo update from the parameters' ``.grad``.  ``key`` is
        the step's sketch key; None fits alpha from exact traces (only the
        fitted PRISM iterations read it).  ``refresh`` (a bool) overrides
        the refresh schedule."""
        if closure is not None:
            raise ValueError("Shampoo.step takes no closure")
        cfg = self.cfg
        lr = cfg.learning_rate
        params = self.param_groups[0]["params"]
        blocks = self.blocks
        if refresh is None:
            every = base.resolve_refresh_period(cfg, "shampoo")
            refresh = every == 1 or self.count % every == 0
        # pass 1: Adam leaves finish; matrix leaves update their EMA
        # factors and queue their inverse-root jobs, L before R
        matrix, jobs = [], []
        for i, (p, a) in enumerate(zip(params, self.axes)):
            g = (p.grad.float() if p.grad is not None
                 else torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device))
            st = self.state[p]
            if "nu" in st:
                b1, b2 = cfg.beta1, cfg.beta2
                mom = b1 * st["mom"] + (1 - b1) * g
                nu = b2 * st["nu"] + (1 - b2) * torch.square(g)
                c1, c2 = base.adam_bias_corrections(b1, b2, self.count)
                p32 = p.float() * (1.0 - lr * cfg.weight_decay) \
                    - lr * (mom / c1) / (torch.sqrt(nu / c2) + cfg.eps)
                st["mom"], st["nu"] = mom, nu
                p.copy_(p32.to(p.dtype))
                continue
            G, meta = base.to_matrix_view(
                blocks.whole(g, i, "mom", kind="opt"), a)
            Gt = G.transpose(-1, -2)
            moved = 0  # the factors' joint squared movement (§12 drift)
            for side, x, y in (("L", G, Gt), ("R", Gt, G)):
                if side in st:
                    new = BETA2 * st[side] + x @ y
                    if "dnorm" in st:
                        moved = moved + torch.sum(
                            torch.square(new - st[side]))
                    st[side] = new
                    jobs.append((i, side + "inv", new))
            if "diagL" in st:
                st["diagL"] = BETA2 * st["diagL"] + torch.sum(G * G, dim=-1)
            if "diagR" in st:
                st["diagR"] = BETA2 * st["diagR"] + torch.sum(G * G, dim=-2)
            if "dnorm" in st:
                st["dnorm"] = st["dnorm"] + torch.sqrt(moved)
            matrix.append((i, G, meta))
        roots = {}  # (leaf, "Linv"/"Rinv") -> a refresh's whole root
        if cfg.precond_async:
            # §12 steady state: no inverse root here; the active caches
            # are served, or the pending twins once their swap is due
            keys = ("", "_iters", "_status") if cfg.matfn_telemetry \
                else ("",)
            base.swap_pending(self, [(self.state[params[i]], name + k)
                                     for i, name, _ in jobs for k in keys])
        elif refresh and jobs:
            invs, its, sts = self._fresh_invs(jobs, key)
            for j, (i, name, _) in enumerate(jobs):
                st = self.state[params[i]]
                roots[i, name] = invs[j]
                st[name] = blocks.block(invs[j], i, name)
                if its is not None:
                    st[name + "_iters"], st[name + "_status"] = its[j], sts[j]

        def root_of(i, name):
            # a stale or async step gathers one leaf's cache whole at a
            # time, dropped after the leaf's update
            r = roots.pop((i, name), None)
            return blocks.whole(self.state[params[i]][name], i, name) \
                if r is None else r

        # pass 2: precondition, graft, momentum, apply
        root = 1.0 / (2 * self.p_root)
        for i, G, meta in matrix:
            p = params[i]
            st = self.state[p]
            if "Linv" in st:
                PG = root_of(i, "Linv").float() @ G
            else:
                PG = G / (st["diagL"][..., None] ** root + cfg.shampoo_eps)
            if "Rinv" in st:
                PG = PG @ root_of(i, "Rinv").float()
            else:
                PG = PG / (st["diagR"][..., None, :] ** root
                           + cfg.shampoo_eps)
            gn = torch.sqrt(torch.sum(G * G, dim=(-2, -1), keepdim=True))
            pn = torch.sqrt(torch.sum(PG * PG, dim=(-2, -1), keepdim=True))
            PG = PG * gn / torch.clamp(pn, min=1e-12)
            mom = cfg.momentum * st["mom"] + blocks.block(
                base.from_matrix_view(PG, meta), i, "mom")
            st["mom"] = mom
            p32 = p.float() * (1.0 - lr * cfg.weight_decay) - lr * mom
            p.copy_(p32.to(p.dtype))
        self.count += 1

    # ------------------------------------------------------ refresh plane

    def refresh_inputs(self):
        """The tensors ``pending_twins`` reads: the EMA factors of every
        cached side."""
        return [st[k] for st in (self.state[p] for p in
                                 self.param_groups[0]["params"])
                for k in ("L", "R") if k + "inv_p" in st]

    def pending_twins(self, key):
        """The §12 refresh's pending buffers, one partial dict per
        parameter: the inverse roots of the STORED factors of every
        cached side, with their telemetry twins.  The jobs are queued in
        the reference's slot order (L before R), so that bucket indices,
        hence sketch keys, are the reference's.  On sharded parameters
        each twin is this rank's cache block of the whole root."""
        params = self.param_groups[0]["params"]
        parts = [{} for _ in params]
        jobs = []
        for i in sorted(range(len(params)), key=self.leaf_idx.__getitem__):
            st = self.state[params[i]]
            for side in ("L", "R"):
                if side + "inv_p" in st:
                    jobs.append((i, side + "inv", st[side]))
        if not jobs:
            return parts
        invs, its, sts = self._fresh_invs(jobs, key)
        for j, (i, name, _) in enumerate(jobs):
            parts[i][name + "_p"] = self.blocks.block(invs[j], i, name + "_p")
            if its is not None:
                parts[i][name + "_iters_p"] = its[j]
                parts[i][name + "_status_p"] = sts[j]
        return parts

    def drift_baseline(self):
        """The drift proxy a refresh resets, one partial dict per
        parameter: "rnorm", the joint norm of the factors the twins are
        computed from, and a zero "dnorm"."""
        parts = []
        for p in self.param_groups[0]["params"]:
            st = self.state[p]
            if "dnorm" not in st:
                parts.append({})
                continue
            rsq = sum(torch.sum(torch.square(st[k])) for k in ("L", "R")
                      if k + "inv_p" in st)
            parts.append({"rnorm": torch.sqrt(rsq),
                          "dnorm": torch.zeros_like(st["dnorm"])})
        return parts

    def refresh(self, key):
        """The reference's ``refresh(state, key)``: the pending twins and
        the drift reset, one partial dict per parameter, for
        ``base.install_pending``."""
        return base.merge_partials(self.pending_twins(key),
                                   self.drift_baseline())
