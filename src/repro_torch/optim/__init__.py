"""Optimizers of the port: Muon (+PRISM) with its AdamW branch, Shampoo
with PRISM inverse square roots and its Adam branch, the AdamW baseline,
and the §15 skip-step guard."""
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.optim import base, bucketing
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.muon import Muon
from repro_torch.optim.shampoo import Shampoo


def make_optimizer(cfg: OptimizerConfig,
                   named_params: Iterable[Tuple[str, torch.Tensor]],
                   axes: Dict[str, tuple],
                   shardings: Optional[Dict[str, Any]] = None):
    """The optimizer ``cfg.name`` names, over named parameters and their
    logical axes (counterpart of ``repro.optim.make_optimizer``), wrapped
    in the §15 skip-step guard when ``cfg.skip_nonfinite``.
    ``shardings`` (name -> ``launch.sharding.Sharding``) is a sharded
    model's layout: Muon and Shampoo gather their matrix views whole,
    keep their moments as blocks like the parameters and their cached
    preconditioners (and §12 twins) as ``precond_cache_sharding``
    blocks; AdamW is elementwise on the blocks.  Every optimizer names
    its state's layout in ``blocks`` (``base.Blocks``)."""
    if cfg.name == "muon":
        opt = Muon(named_params, cfg, axes, shardings)
    elif cfg.name == "shampoo":
        opt = Shampoo(named_params, cfg, axes, shardings=shardings)
    elif cfg.name == "adamw":
        opt = AdamW(named_params, cfg, shardings)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return base.skip_nonfinite(opt) if cfg.skip_nonfinite else opt


__all__ = ["AdamW", "Muon", "Shampoo", "base", "bucketing",
           "make_optimizer"]
