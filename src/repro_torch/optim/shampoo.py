"""Shampoo with PRISM inverse square roots (paper Sec. 6.2; counterpart of
``repro/optim/shampoo.py``).

    W <- W - lr * L^{-1/p} G R^{-1/p}     (p = 2)

with L/R the EMA Kronecker factors G G^T / G^T G of each matrix view.
``matfn_method`` selects how the inverse roots are computed: ``prism``
(the coupled PRISM Newton-Schulz iteration, ``matfn.sqrtm``'s Y output),
``polar_express`` (its fixed schedule in the same coupled form) or
``eigh`` (the classical baseline).  A side longer than
``max_precond_dim`` falls back to a diagonal (AdaGrad) preconditioner.
Preconditioned updates are norm-grafted to the raw gradient norm, then
go through heavy-ball momentum and decoupled weight decay; leaves that
are not matrices take Adam.

The inverse roots of every matrix leaf's L and R factors — across leaves,
L before R in the reference's leaf order — stack into one [B, n, n] call
per distinct n (``bucketing.transform_bucketed``), bucket ``bi`` drawing
its sketches from the step's key folded with ``bi``.  They are recomputed
every ``base.resolve_refresh_period`` steps, a count kept on the host (a
Python-bool ``refresh`` forces the choice): a step that does not refresh
serves "Linv"/"Rinv" from the state and launches nothing.

Precision (DESIGN.md §9): the EMA factors and their eps-ridge stay fp32;
the inverse-root chains run at ``matfn_dtype`` with fp32 accumulation,
and the cached inverse roots are stored in ``cfg.cache_dtype``.

Telemetry (DESIGN.md §11/§15): with an adaptive ``matfn_tol`` and the
prism method (``cfg.matfn_telemetry``) each full-matrix side carries
"Linv_iters"/"Rinv_iters" (int32) and "Linv_status"/"Rinv_status" (int8)
per slice, refreshed with the inverse roots.

``step(key=, refresh=)`` does what the reference's ``make_shampoo(cfg,
axes).update`` does without the async refresh plane, which raises here,
as do inverse p-th roots other than p = 2 with PRISM, the methods not
named above and the per-leaf loop (``bucketed=False``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from repro_torch.config import OptimizerConfig, torch_dtype
from repro_torch.core import matfn
from repro_torch.optim import base, bucketing

BETA2 = 0.999   # EMA decay of the Kronecker factors (the reference's)


def _check_supported(cfg: OptimizerConfig, p_root: int) -> None:
    unported = {
        "precond_async (refresh plane, ROADMAP.md Queue 1 item 8b)":
            cfg.precond_async,
        f"p_root={p_root} with PRISM (inverse p-th roots through "
        "core/inverse_newton.py, ROADMAP.md Queue 1 item 6)":
            p_root != 2 and cfg.matfn_method != "eigh",
        f"matfn_method={cfg.matfn_method!r} (newton: ROADMAP.md Queue 1 "
        "item 6)":
            cfg.matfn_method not in ("prism", "eigh", "polar_express"),
        "bucketed=False (the per-leaf loop, ROADMAP.md Queue 1 item 6; "
        "its sketch keys fold in optim/muon.py::leaf_order's index)":
            not cfg.bucketed,
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError("Shampoo options not ported yet: "
                                  + "; ".join(missing))


def inv_root(A: torch.Tensor, p: int, cfg: OptimizerConfig, key,
             with_iters: bool = False):
    """A^{-1/p} per ``cfg.matfn_method`` for fp32 EMA factors A [..., n, n]
    (p = 2 for ``prism`` and ``polar_express``); ``with_iters`` (the
    prism method: ``cfg.matfn_telemetry``) appends the §11 ``iters_used``
    and the §15 int8 status.

    The eps-ridge is applied to the fp32 factor BEFORE any cast: a bf16
    ridge would round eps away against trace-scale entries (§9)."""
    eps = cfg.shampoo_eps
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    Ad = A + eps * tr[..., None, None] * eye / n + eps * eye
    pc = cfg.resolved_prism
    if cfg.matfn_method == "eigh":
        return matfn.inv_proot(Ad, p=p, method="eigh")
    if cfg.matfn_method == "polar_express":
        return matfn.sqrtm(Ad, method="polar_express", iters=pc.iterations,
                           dtype=pc.dtype)[1]
    if with_iters:
        (_, isq), it, st = matfn.sqrtm(Ad, method="prism", cfg=pc, key=key,
                                       iters=pc.iterations,
                                       return_iters=True, return_status=True)
        return isq, it, st
    return matfn.sqrtm(Ad, method="prism", cfg=pc, key=key,
                       iters=pc.iterations)[1]


class Shampoo(torch.optim.Optimizer):
    """Shampoo over named parameters with their logical axes.

    ``named_params``: (name, tensor) pairs, e.g. ``model.named_parameters()``;
    ``axes``: name -> logical-axis tuple (``Model.logical_axes()``), which
    decides the matrix view of every parameter.  Hyperparameters live in
    ``cfg``; gradients are read from ``.grad`` as fp32.  The per-parameter
    state, created here, carries the reference's keys: "mom", "L"/"Linv"
    or "diagL", "R"/"Rinv" or "diagR" (+ the telemetry keys) for matrix
    leaves, "mom"/"nu" for the others.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 cfg: OptimizerConfig, axes: Dict[str, tuple],
                 p_root: int = 2):
        _check_supported(cfg, p_root)
        named = list(named_params)
        super().__init__([p for _, p in named], defaults={})
        self.cfg = cfg
        self.p_root = p_root
        self.axes = [tuple(axes[n]) for n, _ in named]
        self.count = 0
        for (_, p), a in zip(named, self.axes):
            self.state[p] = self._init_state(p, a)

    def _init_state(self, p: torch.Tensor, a: tuple) -> Dict:
        cfg = self.cfg
        mom = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if not base.is_matrix_param(a, tuple(p.shape)):
            return {"mom": mom, "nu": torch.zeros_like(mom)}
        M, _ = base.to_matrix_view(mom, a)
        lead, (m, n) = tuple(M.shape[:-2]), tuple(M.shape[-2:])
        cache = torch_dtype(cfg.cache_dtype)
        st = {"mom": mom}
        for side, k in (("L", m), ("R", n)):
            if k <= cfg.max_precond_dim:
                st[side] = torch.zeros(lead + (k, k), dtype=torch.float32,
                                       device=p.device)
                st[side + "inv"] = torch.zeros(lead + (k, k), dtype=cache,
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
        return st

    def _fresh_invs(self, jobs, key):
        """(invs, iters, statuses) of the jobs' factors, the last two None
        unless ``cfg.matfn_telemetry``: one batched call per shape bucket,
        keys folded by bucket index."""
        cfg = self.cfg
        cache = torch_dtype(cfg.cache_dtype)
        tele = cfg.matfn_telemetry

        def one_bucket(stacked, b, bi):
            kk = key.fold_in(bi) if key is not None else None
            if tele:
                inv, it, st = inv_root(stacked, self.p_root, cfg, kk,
                                       with_iters=True)
                return inv.to(cache), it, st
            return inv_root(stacked, self.p_root, cfg, kk).to(cache)

        mats = [A for (_, _, A) in jobs]
        if tele:
            return bucketing.transform_bucketed(mats, one_bucket,
                                                with_aux=2)
        return bucketing.transform_bucketed(mats, one_bucket), None, None

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
            G, meta = base.to_matrix_view(g, a)
            Gt = G.transpose(-1, -2)
            if "L" in st:
                st["L"] = BETA2 * st["L"] + G @ Gt
                jobs.append((i, "Linv", st["L"]))
            else:
                st["diagL"] = BETA2 * st["diagL"] + torch.sum(G * G, dim=-1)
            if "R" in st:
                st["R"] = BETA2 * st["R"] + Gt @ G
                jobs.append((i, "Rinv", st["R"]))
            else:
                st["diagR"] = BETA2 * st["diagR"] + torch.sum(G * G, dim=-2)
            matrix.append((i, G, meta))
        if refresh and jobs:
            invs, its, sts = self._fresh_invs(jobs, key)
            for j, (i, name, _) in enumerate(jobs):
                st = self.state[params[i]]
                st[name] = invs[j]
                if its is not None:
                    st[name + "_iters"], st[name + "_status"] = its[j], sts[j]
        # pass 2: precondition, graft, momentum, apply
        root = 1.0 / (2 * self.p_root)
        for i, G, meta in matrix:
            p = params[i]
            st = self.state[p]
            if "Linv" in st:
                PG = st["Linv"].float() @ G
            else:
                PG = G / (st["diagL"][..., None] ** root + cfg.shampoo_eps)
            if "Rinv" in st:
                PG = PG @ st["Rinv"].float()
            else:
                PG = PG / (st["diagR"][..., None, :] ** root
                           + cfg.shampoo_eps)
            gn = torch.sqrt(torch.sum(G * G, dim=(-2, -1), keepdim=True))
            pn = torch.sqrt(torch.sum(PG * PG, dim=(-2, -1), keepdim=True))
            PG = PG * gn / torch.clamp(pn, min=1e-12)
            mom = cfg.momentum * st["mom"] + base.from_matrix_view(PG, meta)
            st["mom"] = mom
            p32 = p.float() * (1.0 - lr * cfg.weight_decay) - lr * mom
            p.copy_(p32.to(p.dtype))
        self.count += 1
