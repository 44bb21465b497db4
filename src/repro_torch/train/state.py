"""Train-step construction: mixed precision, clipping, Muon (counterpart of
``repro/train/state.py::make_train_step``).

Master parameters live in fp32 (the model's own parameters); the forward
and backward run in each parameter's compute dtype (bf16 matrices, fp32
norms) through ``Model.cast_params``, so the gradients that reach the
masters are fp32.  They are clipped by global norm, then the optimizer
steps.  As in the reference, the PRISM sketch key of global step s is the
root key folded with s (``key.fold_in(s)``), whatever step a run starts or
resumes at; the fitted PRISM iterations draw their sketches from it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.core.rng import Key
from repro_torch.models.transformer import Model
from repro_torch.optim import base


def make_train_step(model: Model, opt: torch.optim.Optimizer,
                    ocfg: OptimizerConfig, key=None) -> Callable:
    """Build train_step(batch, step, refresh=None) -> metrics dict (loss,
    grad_norm, ce, ..., and "precond_drift" under ``precond_async``).

    Updates the model's parameters and the optimizer state in place.
    ``step`` is the global step (the sketch key is ``key.fold_in(step)``;
    ``key`` is the root sketch key, default ``Key(0)``, the reference's
    ``PRNGKey(0)``); ``refresh`` is the optimizer's staleness override (a
    bool, or None for its own schedule).
    """
    if ocfg.grads_dtype != "float32" or ocfg.gradient_compression != "none":
        raise NotImplementedError(
            "bf16 gradients and gradient compression are ported with the "
            "sharded training slice (ROADMAP.md Queue 1 item 11)")
    params = list(model.parameters())
    root = Key(0) if key is None else key

    def train_step(batch, step: int, refresh=None):
        for p in params:
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        clipped, gnorm = base.clip_by_global_norm(grads, ocfg.grad_clip_norm)
        for p, g in zip(params, clipped):
            p.grad = g
        # the unclipped gradients are dead: free them before the
        # optimizer's working set (9 GiB at recurrentgemma-2b's width)
        del grads, clipped
        opt.step(key=root.fold_in(step), refresh=refresh)
        metrics = dict(metrics, loss=loss.detach(), grad_norm=gnorm)
        if ocfg.precond_async:
            # §12: the cached preconditioners' drift proxy, a device
            # scalar the Trainer reads with the loss and feeds back to
            # the AsyncPrecondService's trigger
            metrics["precond_drift"] = base.precond_drift(opt)
        return metrics

    return train_step
