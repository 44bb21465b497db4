"""Shampoo with PRISM inverse square roots (paper Sec. 6.2; counterpart of
``repro/optim/shampoo.py``).

    W <- W - lr * L^{-1/p} G R^{-1/p}     (p = 2)

with L/R the EMA Kronecker factors G G^T / G^T G of each matrix view.
``matfn_method`` selects how the inverse roots are computed: ``prism``
(the coupled PRISM Newton-Schulz iteration, ``matfn.sqrtm``'s Y output)
or ``eigh`` (the classical baseline).  A side longer than
``max_precond_dim`` falls back to a diagonal (AdaGrad) preconditioner.
Preconditioned updates are norm-grafted to the raw gradient norm, then
go through heavy-ball momentum and decoupled weight decay; leaves that
are not matrices take Adam.

The inverse roots of every matrix leaf's L and R factors — across leaves,
L before R in the reference's leaf order — stack into one [B, n, n] call
per distinct n (``bucketing.transform_bucketed``), bucket ``bi`` drawing
its sketches from the step's key folded with ``bi``.  They are recomputed
every ``base.resolve_refresh_period`` steps, a count kept on the host: a
step that does not refresh serves "Linv"/"Rinv" from the state and
launches nothing.

Precision (DESIGN.md §9): the EMA factors and their eps-ridge stay fp32;
the inverse-root chains run at ``matfn_dtype`` with fp32 accumulation,
and the cached inverse roots are stored in ``cfg.cache_dtype``.

``step(key=...)`` does what the reference's ``make_shampoo(cfg,
axes).update`` does without the async refresh plane and without the
adaptive-tol telemetry state, which raise here, as do inverse p-th roots
other than p = 2 with PRISM, the methods not named above and the
per-leaf loop (``bucketed=False``).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

from repro_torch.config import OptimizerConfig, torch_dtype
from repro_torch.core import matfn
from repro_torch.optim import base, bucketing

BETA2 = 0.999   # EMA decay of the Kronecker factors (the reference's)


def _check_supported(cfg: OptimizerConfig, p_root: int) -> None:
    unported = {
        "precond_async (refresh plane, ROADMAP.md Queue 1 item 8)":
            cfg.precond_async,
        "matfn_tol (the optimizers' adaptive-stopping telemetry state, "
        "ROADMAP.md Queue 1 item 3)":
            cfg.matfn_tol is not None,
        f"p_root={p_root} with PRISM (inverse p-th roots through "
        "core/inverse_newton.py, ROADMAP.md Queue 1 item 6)":
            p_root != 2 and cfg.matfn_method != "eigh",
        f"matfn_method={cfg.matfn_method!r} (polar_express: ROADMAP.md "
        "Queue 1 item 3; newton: item 6)":
            cfg.matfn_method not in ("prism", "eigh"),
        "bucketed=False (the per-leaf loop, ROADMAP.md Queue 1 item 6; "
        "its sketch keys fold in optim/muon.py::leaf_order's index)":
            not cfg.bucketed,
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError("Shampoo options not ported yet: "
                                  + "; ".join(missing))


def inv_root(A: torch.Tensor, p: int, cfg: OptimizerConfig, key
             ) -> torch.Tensor:
    """A^{-1/p} per ``cfg.matfn_method`` for fp32 EMA factors A [..., n, n]
    (p = 2 for ``prism``).

    The eps-ridge is applied to the fp32 factor BEFORE any cast: a bf16
    ridge would round eps away against trace-scale entries (§9)."""
    eps = cfg.shampoo_eps
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    Ad = A + eps * tr[..., None, None] * eye / n + eps * eye
    if cfg.matfn_method == "eigh":
        return matfn.inv_proot(Ad, p=p, method="eigh")
    pc = cfg.resolved_prism
    return matfn.sqrtm(Ad, method="prism", cfg=pc, key=key,
                       iters=pc.iterations)[1]


class Shampoo(torch.optim.Optimizer):
    """Shampoo over named parameters with their logical axes.

    ``named_params``: (name, tensor) pairs, e.g. ``model.named_parameters()``;
    ``axes``: name -> logical-axis tuple (``Model.logical_axes()``), which
    decides the matrix view of every parameter.  Hyperparameters live in
    ``cfg``; gradients are read from ``.grad`` as fp32.  The per-parameter
    state carries the reference's keys: "mom", "L"/"Linv" or "diagL",
    "R"/"Rinv" or "diagR" for matrix leaves, "mom"/"nu" for the others.
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
            else:
                st["diag" + side] = torch.zeros(lead + (k,),
                                                dtype=torch.float32,
                                                device=p.device)
        return st

    def _fresh_invs(self, jobs, key) -> List[torch.Tensor]:
        """Inverse roots of the jobs' factors: one batched call per shape
        bucket, keys folded by bucket index."""
        cfg = self.cfg
        cache = torch_dtype(cfg.cache_dtype)

        def one_bucket(stacked, b, bi):
            kk = key.fold_in(bi) if key is not None else None
            return inv_root(stacked, self.p_root, cfg, kk).to(cache)

        return bucketing.transform_bucketed([A for (_, _, A) in jobs],
                                            one_bucket)

    @torch.no_grad()
    def step(self, closure=None, key=None):
        """One Shampoo update from the parameters' ``.grad``.  ``key`` is
        the step's sketch key; None fits alpha from exact traces (only the
        fitted PRISM iterations read it)."""
        if closure is not None:
            raise ValueError("Shampoo.step takes no closure")
        cfg = self.cfg
        lr = cfg.learning_rate
        params = self.param_groups[0]["params"]
        refresh = self.count % base.resolve_refresh_period(cfg,
                                                           "shampoo") == 0
        # pass 1: Adam leaves finish; matrix leaves update their EMA
        # factors and queue their inverse-root jobs, L before R
        matrix, jobs = [], []
        for i, (p, a) in enumerate(zip(params, self.axes)):
            g = (p.grad.float() if p.grad is not None
                 else torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device))
            st = self.state[p]
            if "mom" not in st:
                st.update(self._init_state(p, a))
            if "nu" in st:
                b1, b2 = cfg.beta1, cfg.beta2
                mom = b1 * st["mom"] + (1 - b1) * g
                nu = b2 * st["nu"] + (1 - b2) * torch.square(g)
                t = float(self.count + 1)
                p32 = p.float() * (1.0 - lr * cfg.weight_decay) \
                    - lr * (mom / (1 - b1 ** t)) / (
                        torch.sqrt(nu / (1 - b2 ** t)) + cfg.eps)
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
            for (i, name, _), inv in zip(jobs, self._fresh_invs(jobs, key)):
                self.state[params[i]][name] = inv
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
