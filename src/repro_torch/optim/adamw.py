"""AdamW, the paper's Sec. 6.2 baseline (counterpart of
``repro/optim/adamw.py``): every parameter takes the same Adam update with
decoupled weight decay, no matrix function at all.  On a sharded model
(``shardings``) it is elementwise on the parameters' blocks, and its
moments are blocks like them (``base.Blocks``)."""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.optim import base


class AdamW(torch.optim.Optimizer):
    """AdamW over named parameters; hyperparameters live in ``cfg``,
    gradients are read from ``.grad`` as fp32, and the state of each
    parameter ("mom", "nu", fp32) is created here.  ``shardings`` (name
    -> ``launch.sharding.Sharding``) is a sharded model's layout."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 cfg: OptimizerConfig,
                 shardings: Optional[Dict[str, Any]] = None):
        named = list(named_params)
        super().__init__([p for _, p in named], defaults={})
        self.cfg = cfg
        self.count = 0
        self.blocks = base.Blocks(named, shardings)
        for i, (_, p) in enumerate(named):
            mom = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            self.state[p] = {"mom": mom, "nu": torch.zeros_like(mom)}
            self.blocks.like_param(i, "mom", "nu")

    @torch.no_grad()
    def step(self, closure=None, key=None, refresh=None):
        """One AdamW update.  ``key`` and ``refresh`` are accepted for the
        optimizers' common signature; AdamW has no sketch and no
        preconditioner cache."""
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        cfg = self.cfg
        b1, b2 = cfg.beta1, cfg.beta2
        c1, c2 = base.adam_bias_corrections(b1, b2, self.count)
        lr = cfg.learning_rate
        for p in self.param_groups[0]["params"]:
            g = (p.grad.float() if p.grad is not None
                 else torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device))
            st = self.state[p]
            mom = b1 * st["mom"] + (1 - b1) * g
            nu = b2 * st["nu"] + (1 - b2) * torch.square(g)
            p32 = p.float() * (1.0 - lr * cfg.weight_decay) \
                - lr * (mom / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            st["mom"], st["nu"] = mom, nu
            p.copy_(p32.to(p.dtype))
        self.count += 1
