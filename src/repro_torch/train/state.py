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
ranks' means is the global mean.  The moe family's aux loss is the
global batch's on every rank (``models/moe.py``: its statistics are
summed over the data group, the gradient through them scaled by its
size), so the mean of the ranks' gradients is one process's too.  The
optimizer steps under the mesh's
activation-sharding context, which shards its matrix functions over the
batch of each bucket (DESIGN.md §8); every rank then holds the same
parameters and state.

Sharded parameters (``Model.shard``: tensor parallelism and ZeRO-3 on a
(data, model) mesh): each rank holds its block of every parameter and
computes the loss of the rows its strategy's ``batch`` rule gives it
((pod, data) under "tp", the whole mesh under "zero").  Each gradient
then gets exactly the reduction it needs, one flat SUM all-reduce a
(set of axes, dtype) a step, and one division by the ranks holding
distinct rows: a leaf gathered on use arrives summed over the ranks it
was gathered from (``collectives.gather_from``'s backward), so it is
summed over the remaining batch axes only; a replicated one over every
batch axis; and under "tp" the leaves replicated over the model axis but
used on a rank's heads (``attention.TP_PARTIAL``) are also summed over
the model axis (in every attention layer: ``layers.attn.*`` and the
hybrid's ``layers.p{i}.attn.*``).  A leaf used on replicated activations
(the norm scales, the moe router, whose gates enter the experts through
``collectives.copy_to``, ``vision_proj``) gets no model sum, and neither
do the blocks a model rank owns: its experts, or every expert's columns;
Mamba's channel blocks (``conv_*``, ``x_proj``'s and ``A_log``'s rows,
``dt_proj``'s columns, ``dt_bias``, ``D``, ``out_proj``'s rows) and the
RG-LRU's (``in_x``/``in_gate``'s columns, ``w_a``/``w_i``'s rows, whose
gradient the gates' reduce-scatter all-gathers, ``b_a``, ``b_i``,
``lam``, ``conv_*``, ``out_proj``); each codebook's vocab rows.  Mamba's
``in_proj``, gathered over the model axis on use, arrives summed over
it.  The
clipping norm counts every element once, each block on the ranks at
coordinate 0 of the axes it is replicated over.
bf16 gradients reduce in bf16 as on the data axis; int8 compression
round-trips the reference's 256-blocks of the flattened whole leaf (a
sharded leaf is gathered, round-tripped, and cut back to its block).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import collectives, sharding_ctx
from repro_torch.config import OptimizerConfig
from repro_torch.core.rng import Key
from repro_torch.launch import sharding
from repro_torch.models import attention as attn
from repro_torch.models import moe
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


def batch_group(model: Model, mesh):
    """(process group, size) of the ranks holding distinct rows of the
    batch: ``mesh``'s data axes with replicated parameters, the layout's
    batch axes on a sharded model; (None, 1) when that is one rank."""
    lay = model.layout
    if lay is None:
        return data_group(mesh)
    n = lay.batch_size
    return (lay.mesh.group(lay.batch_axes) if n > 1 else None), n


def _mean_by(tensors: List[torch.Tensor], keys: list, group_of: Callable,
             n: int, kind: str) -> List[torch.Tensor]:
    """Each tensor SUM all-reduced over ``group_of(its key)`` (none for
    None), one flat buffer a key and dtype, in that dtype, then upcast to
    fp32 and divided by ``n``."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for key, dt in dict.fromkeys(zip(keys, (t.dtype for t in tensors))):
        idx = [i for i, t in enumerate(tensors)
               if keys[i] == key and t.dtype == dt]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        group = group_of(key)
        if group is not None:
            collectives.all_reduce(flat, "sum", group, kind=kind)
        flat = flat.float().div_(n)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out  # type: ignore[return-value]


def average(tensors: List[torch.Tensor], group, n: int,
            kind: str = "grad") -> List[torch.Tensor]:
    """Each tensor's mean over the group: one flat SUM all-reduce a
    dtype, in that dtype, then upcast to fp32 and divided by ``n``."""
    return _mean_by(tensors, [None] * len(tensors), lambda _: group, n,
                    kind)


def reduction_axes(layout, names: List[str]) -> List[tuple]:
    """The mesh axes each gradient is SUM all-reduced over (module
    docstring), in mesh order."""
    out = []
    for k in names:
        red = [a for a in layout.batch_axes
               if a not in layout.gathered_axes(k)]
        parts = k.split(".")
        if layout.tp is not None and parts[-2:-1] == ["attn"] and \
                parts[-1] in attn.TP_PARTIAL:
            red.append("model")
        out.append(tuple(a for a in layout.mesh.axis_names if a in red))
    return out


def reduce_sharded(grads: List[torch.Tensor], layout, axes: List[tuple]
                   ) -> List[torch.Tensor]:
    """Each gradient SUM all-reduced over its ``axes`` (one flat buffer a
    set of axes and dtype), upcast to fp32 and divided by the ranks
    holding distinct rows."""
    return _mean_by(grads, axes,
                    lambda red: layout.mesh.group(red) if red else None,
                    layout.batch_size, "grad")


def sharded_global_norm(grads: List[torch.Tensor], layout,
                        names: List[str]) -> torch.Tensor:
    """The global norm of the whole gradients from every rank's blocks:
    each block's sum of squares counted on the ranks at coordinate 0 of
    every axis it is replicated over, one SUM all-reduce over the
    world."""
    mesh = layout.mesh
    sq = []
    for k, g in zip(names, grads):
        split = sharding.sharded_axes(layout.shardings[k])
        owner = all(layout.coords[a] == 0 for a in mesh.axis_names
                    if a not in split)
        s = torch.sum(torch.square(g.float()))
        sq.append(s if owner else torch.zeros_like(s))
    vec = torch.stack(sq)
    collectives.all_reduce(vec, "sum", mesh.group(mesh.axis_names),
                           kind="grad")
    return torch.sqrt(torch.sum(vec))


def int8_sharded(grads: List[torch.Tensor], layout, names: List[str]
                 ) -> List[torch.Tensor]:
    """The int8 round trip of each whole leaf: a sharded gradient is
    gathered over its split axes, round-tripped, and cut to its
    block."""
    out = []
    for k, g in zip(names, grads):
        sh = layout.shardings[k]
        if not sharding.sharded_axes(sh):
            out.append(compression.int8_roundtrip_leaf(g))
            continue
        full = sharding.gather_full(g, sh, kind="int8")
        out.append(sharding.local_block(
            compression.int8_roundtrip_leaf(full), sh, layout.coords)
            .contiguous())
    return out


def make_train_step(model: Model, opt: torch.optim.Optimizer,
                    ocfg: OptimizerConfig, key=None, mesh=None) -> Callable:
    """Build train_step(batch, step, refresh=None) -> metrics dict (loss,
    grad_norm, ce, ..., and "precond_drift" under ``precond_async``).

    Updates the model's parameters and the optimizer state in place.
    ``step`` is the global step (the sketch key is ``key.fold_in(step)``;
    ``key`` is the root sketch key, default ``Key(0)``, the reference's
    ``PRNGKey(0)``); ``refresh`` is the optimizer's staleness override (a
    bool, or None for its own schedule).  With a ``mesh``, ``batch`` is
    this rank's rows of the global batch: its rows of the data axes with
    replicated parameters, of the strategy's batch axes on a sharded
    model (``model.layout``, whose mesh it is).
    """
    if ocfg.grads_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"grads_dtype {ocfg.grads_dtype!r}")
    if ocfg.gradient_compression not in ("none", "int8"):
        raise ValueError(f"gradient_compression "
                         f"{ocfg.gradient_compression!r}")
    layout = model.layout
    if layout is not None:
        if mesh is not None and mesh is not layout.mesh:
            raise ValueError("a sharded model steps on its own mesh")
        mesh = layout.mesh
    group, n_data = batch_group(model, mesh)
    if layout is None and group is not None:
        # the moe layers route the global batch over the data ranks
        model.rows = moe.Rows(group, n_data, collectives.rank(group))
    rules = None if mesh is None else sharding.activation_rules(
        model.cfg, mesh, "tp" if layout is None else layout.strategy)
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

    red_axes = None if layout is None else reduction_axes(layout, names)

    def train_step(batch, step: int, refresh=None):
        if rules is None:
            grads, metrics = grads_of(batch)
        else:
            with sharding_ctx.activation_sharding(mesh, rules):
                grads, metrics = grads_of(batch)
        if layout is not None:
            grads = reduce_sharded(grads, layout, red_axes)
        elif group is not None:
            grads = average(grads, group, n_data)
        else:
            grads = [g.float() for g in grads]
        if group is not None:
            dev = metrics["loss"].device
            avg = average([torch.stack([
                torch.as_tensor(metrics[k], dtype=torch.float32, device=dev)
                for k in AVERAGED])], group, n_data, kind="metrics")[0]
            metrics.update({k: avg[i] for i, k in enumerate(AVERAGED)})
            metrics["ppl_proxy"] = torch.exp(
                torch.clamp(metrics["ce"], max=20.0))
        norm = None if layout is None else \
            sharded_global_norm(grads, layout, names)
        clipped, gnorm = base.clip_by_global_norm(grads, ocfg.grad_clip_norm,
                                                  norm=norm)
        if ocfg.gradient_compression == "int8":
            clipped = compression.int8_roundtrip(clipped) \
                if layout is None else int8_sharded(clipped, layout, names)
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
