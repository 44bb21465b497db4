"""Train-step construction: mixed precision, data parallelism, clipping,
compression, the optimizer (counterpart of
``repro/train/state.py::make_train_step`` and ``opt_state_shardings``).

Master parameters live in fp32 (the model's own parameters); the forward
and backward run in each parameter's compute dtype (bf16 matrices, fp32
norms) through ``Model.cast_params``, so the gradients that reach the
masters are fp32.  With ``grads_dtype="bfloat16"`` the step differentiates
with respect to the compute-dtype parameters themselves, so the gradients
(and their data-parallel reduction) stay bf16 until they are upcast to
fp32.  They are clipped by global norm, with ``gradient_compression=
"int8"`` passed through the int8 round trip, and the optimizer steps.  As
in the reference, the PRISM sketch key of global step s is the root key
folded with s (``key.fold_in(s)``), whatever step a run starts or resumes
at; the fitted PRISM iterations draw their sketches from it.

Data parallelism (``mesh`` with a batch axis larger than 1): each rank
computes the loss of its own rows; the gradients are averaged over the
data group before clipping, so clipping sees the global norm, one flat
buffer a gradient dtype a step (``collectives.all_reduce``); the loss
and metrics are averaged the same way.  The dense family's CE is the
mean over B·(S−1) tokens and every row has as many, so the mean of the
ranks' means is the global mean.  The optimizer steps under the mesh's
activation-sharding context, which shards its matrix functions over the
batch of each bucket (DESIGN.md §8); every rank then holds the same
parameters and state.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import collectives, sharding_ctx
from repro_torch.config import OptimizerConfig
from repro_torch.core.rng import Key
from repro_torch.launch import sharding
from repro_torch.models.transformer import Model
from repro_torch.optim import base, compression

#: metrics averaged over the data group (ppl_proxy is recomputed from ce)
AVERAGED = ("loss", "ce", "aux")


def data_size(mesh) -> int:
    """The ranks ``mesh``'s batch axes hold (1 without a mesh)."""
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in sharding.batch_axes(mesh))


def data_group(mesh):
    """(process group, size) of ``mesh``'s batch axes; (None, 1) without a
    mesh or when they hold one rank."""
    n = data_size(mesh)
    return (mesh.group(sharding.batch_axes(mesh)), n) if n > 1 else (None, 1)


def average(tensors: List[torch.Tensor], group, n: int
            ) -> List[torch.Tensor]:
    """Each tensor's mean over the group: one flat SUM all-reduce a
    dtype, in that dtype, then upcast to fp32 and divided by ``n``."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dt in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collectives.all_reduce(flat, "sum", group)
        flat = flat.float().div_(n)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out  # type: ignore[return-value]


def make_train_step(model: Model, opt: torch.optim.Optimizer,
                    ocfg: OptimizerConfig, key=None, mesh=None) -> Callable:
    """Build train_step(batch, step, refresh=None) -> metrics dict (loss,
    grad_norm, ce, ..., and "precond_drift" under ``precond_async``).

    Updates the model's parameters and the optimizer state in place.
    ``step`` is the global step (the sketch key is ``key.fold_in(step)``;
    ``key`` is the root sketch key, default ``Key(0)``, the reference's
    ``PRNGKey(0)``); ``refresh`` is the optimizer's staleness override (a
    bool, or None for its own schedule).  With a ``mesh`` (data axis only:
    ``sharding_ctx.check_data_axis``), ``batch`` is this rank's rows of
    the global batch.
    """
    if ocfg.grads_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"grads_dtype {ocfg.grads_dtype!r}")
    if ocfg.gradient_compression not in ("none", "int8"):
        raise ValueError(f"gradient_compression "
                         f"{ocfg.gradient_compression!r}")
    if mesh is not None:
        sharding_ctx.check_data_axis(mesh)
    group, n_data = data_group(mesh)
    rules = None if mesh is None else \
        sharding.activation_rules(model.cfg, mesh)
    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    dtypes = model.param_dtypes()
    root = Key(0) if key is None else key

    def grads_of(batch):
        for p in params:
            p.grad = None
        if ocfg.grads_dtype == "bfloat16":
            # differentiate wrt the compute-dtype parameters: the
            # gradients (and their reduction) stay bf16
            pc = {k: p.detach().to(dtypes[k]).requires_grad_()
                  for k, p in zip(names, params)}
            loss, metrics = model.loss(batch, params=pc)
            grads = torch.autograd.grad(loss, list(pc.values()),
                                        allow_unused=True)
            grads = [torch.zeros_like(pc[k]) if g is None else g
                     for k, g in zip(names, grads)]
        else:
            loss, metrics = model.loss(batch)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            for p in params:
                p.grad = None
        metrics = dict(metrics, loss=loss)
        return grads, {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}

    def train_step(batch, step: int, refresh=None):
        grads, metrics = grads_of(batch)
        if group is not None:
            grads = average(grads, group, n_data)
            dev = metrics["loss"].device
            avg = average([torch.stack([
                torch.as_tensor(metrics[k], dtype=torch.float32, device=dev)
                for k in AVERAGED])], group, n_data)[0]
            metrics.update({k: avg[i] for i, k in enumerate(AVERAGED)})
            metrics["ppl_proxy"] = torch.exp(
                torch.clamp(metrics["ce"], max=20.0))
        else:
            grads = [g.float() for g in grads]
        clipped, gnorm = base.clip_by_global_norm(grads, ocfg.grad_clip_norm)
        if ocfg.gradient_compression == "int8":
            clipped = compression.int8_roundtrip(clipped)
        for p, g in zip(params, clipped):
            p.grad = g
        # the unclipped gradients are dead: free them before the
        # optimizer's working set (9 GiB at recurrentgemma-2b's width)
        del grads, clipped
        if rules is None:
            opt.step(key=root.fold_in(step), refresh=refresh)
        else:
            with sharding_ctx.activation_sharding(mesh, rules):
                opt.step(key=root.fold_in(step), refresh=refresh)
        metrics["grad_norm"] = gnorm
        if ocfg.precond_async:
            # §12: the cached preconditioners' drift proxy, a device
            # scalar the Trainer reads with the loss and feeds back to
            # the AsyncPrecondService's trigger
            metrics["precond_drift"] = base.precond_drift(opt)
        return metrics

    return train_step


def opt_state_shardings(mesh, opt: torch.optim.Optimizer, named_params,
                        param_shardings: Dict[str, sharding.Sharding]
                        ) -> Dict:
    """Sharding tree of the optimizer's state in the Trainer's checkpoint
    layout ({name: {key: Sharding}, "count", ...}) over ``named_params``
    ((name, parameter) pairs): a buffer of its parameter's shape shards as
    the parameter; the cached preconditioners
    (``PRECOND_CACHE_STATE_KEYS``, the §12 twins included) take
    ``precond_cache_sharding``; everything else is replicated."""
    rep = sharding.replicated(mesh)
    out: Dict = {}
    for k, p in named_params:
        slot = {}
        for sk, v in opt.state[p].items():
            if tuple(v.shape) == tuple(p.shape):
                slot[sk] = param_shardings[k]
            elif sk in sharding.PRECOND_CACHE_STATE_KEYS and v.dim() >= 2:
                slot[sk] = sharding.precond_cache_sharding(mesh,
                                                           tuple(v.shape))
            else:
                slot[sk] = rep
        out[k] = slot
    for k in ("count", "pending_at"):
        if hasattr(opt, k):
            out[k] = rep
    if isinstance(opt, base.SkipNonfinite):
        out["bad_steps"] = rep
    return out
