"""Optimizers of the port: Muon (+PRISM) with its AdamW branch, and
Shampoo with PRISM inverse square roots and its Adam branch."""
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.optim import base, bucketing
from repro_torch.optim.muon import Muon
from repro_torch.optim.shampoo import Shampoo


def make_optimizer(cfg: OptimizerConfig,
                   named_params: Iterable[Tuple[str, torch.Tensor]],
                   axes: Dict[str, tuple]) -> torch.optim.Optimizer:
    """The optimizer ``cfg.name`` names, over named parameters and their
    logical axes (counterpart of ``repro.optim.make_optimizer``)."""
    if cfg.skip_nonfinite:
        raise NotImplementedError(
            "skip_nonfinite (the §15 skip-step guard) is ported with the "
            "optimizer spine (ROADMAP.md Queue 1 item 4)")
    if cfg.name == "muon":
        return Muon(named_params, cfg, axes)
    if cfg.name == "shampoo":
        return Shampoo(named_params, cfg, axes)
    raise NotImplementedError(
        f"optimizer {cfg.name!r} is not ported yet (adamw: ROADMAP.md "
        "Queue 1 item 4)")


__all__ = ["Muon", "Shampoo", "base", "bucketing", "make_optimizer"]
