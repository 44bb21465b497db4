"""Train-step construction: mixed precision, clipping, Muon (counterpart of
``repro/train/state.py::make_train_step``).

Master parameters live in fp32 (the model's own parameters); the forward
and backward run in each parameter's compute dtype (bf16 matrices, fp32
norms) through ``Model.cast_params``, so the gradients that reach the
masters are fp32.  They are clipped by global norm, then the optimizer
steps.  The reference derives a PRISM sketch key from the step; the
warm-only chains ported so far draw no sketch, so no key is made.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.models.transformer import Model
from repro_torch.optim import base


def make_train_step(model: Model, opt: torch.optim.Optimizer,
                    ocfg: OptimizerConfig) -> Callable:
    """Build train_step(batch) -> metrics dict (loss, grad_norm, ce, ...).

    Updates the model's parameters and the optimizer state in place.
    """
    if ocfg.grads_dtype != "float32" or ocfg.gradient_compression != "none":
        raise NotImplementedError(
            "bf16 gradients and gradient compression are ported with the "
            "sharded training slice (ROADMAP.md Queue 1 item 11)")
    params = list(model.parameters())

    def train_step(batch):
        for p in params:
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        clipped, gnorm = base.clip_by_global_norm(grads, ocfg.grad_clip_norm)
        for p, g in zip(params, clipped):
            p.grad = g
        opt.step()
        return dict(metrics, loss=loss.detach(), grad_norm=gnorm)

    return train_step
