"""Optimizers of the port: Muon (+PRISM) with its AdamW branch."""
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.optim import base, bucketing
from repro_torch.optim.muon import Muon


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
    raise NotImplementedError(
        f"optimizer {cfg.name!r} is not ported yet (adamw: ROADMAP.md "
        "Queue 1 item 4; shampoo: item 6)")


__all__ = ["Muon", "base", "bucketing", "make_optimizer"]
