"""The port's collectives, in one place and counted.

Every collective the port issues goes through this module: ``all_gather``
(the §8 engine, DESIGN.md §8; a sharded leaf gathered whole),
``reduce_scatter`` (a gathered leaf's gradient) and ``all_reduce`` with
SUM or MAX (the gradient and metric reductions,
``optim/compression.py::int8_psum``, the local reshard's Gram).  Each
call appends its op, dtype, element count, host time and ``kind`` (what
issued it: "tp", "fsdp", "engine", "grad", "gram", "opt", "cache" (a
cached preconditioner's blocks gathered whole), "drift" (the §12 drift
proxy's world sums), "verdict" (a world AND of a refresh's or the
guard's finiteness), "tp_gather" (Mamba's ``in_proj`` gathered over the
model axis), "tp_sum" (Mamba's ``x_proj`` sum over the model axis),
"tp_scatter" (the RG-LRU gates' reduce-scatter), "kv_q" (a decode
step's q gathered over the model axis), "kv_seq" (the decode softmax's
MAX and SUMs over the ranks holding a lane's cache slots), "logits" (the
serving logits' vocab blocks gathered), "lanes" (the serving lanes
gathered), ...) to the census that
``count_collectives`` opens, as ``kernels/ops.py::count_launches`` counts
kernel launches.

Tensor parallelism (Megatron's pattern) differentiates through four
autograd Functions over a group, each issuing one counted collective a
pass:

  copy_to(x)           identity forward, SUM all-reduce of the gradient
                       (the input of a column-parallel projection)
  reduce_from(x)       SUM all-reduce forward, identity backward (the
                       output of a row-parallel projection)
  gather_from(x, dim)  all-gather along ``dim`` forward; backward keeps
                       this rank's slice of the gradient summed over the
                       group (one reduce-scatter, which gloo runs on
                       CUDA tensors: ``tools/tp_probe.py`` checks it)
  reduce_scatter_from(x, dim)
                       its transpose: this rank's block along ``dim`` of
                       the SUM over the group forward, the gradient
                       all-gathered along ``dim`` backward (a row-parallel
                       projection whose every output column is partial
                       and whose rank keeps its own columns: the RG-LRU
                       gates)

On CUDA tensors the collective runs through the backend ``init_world``
chose and printed.  Under gloo (ranks that share a device) the backend
copies a CUDA tensor to the host, reduces there and copies back inside
the call, so the host waits for the tensor's producers: a call's host
time covers those copies.  The kernels still run on the card.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple

import torch
import torch.distributed as dist


class Call(NamedTuple):
    """One collective: ``op`` is "all_gather", "reduce_scatter",
    "all_reduce_sum" or "all_reduce_max"; ``numel`` the elements this
    rank contributed; ``kind`` what issued it."""

    op: str
    dtype: torch.dtype
    numel: int
    ms: float
    kind: str = ""

    @property
    def nbytes(self) -> int:
        return self.numel * torch.empty((), dtype=self.dtype).element_size()


_CENSUS: List[List[Call]] = []

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@contextlib.contextmanager
def count_collectives():
    """Record every collective issued inside the block; yields the list
    the calls are appended to (nested blocks each see their own)."""
    calls: List[Call] = []
    _CENSUS.append(calls)
    try:
        yield calls
    finally:
        _CENSUS.remove(calls)


def _record(op: str, x: torch.Tensor, t0: float, kind: str = "") -> None:
    call = Call(op, x.dtype, x.numel(), (time.perf_counter() - t0) * 1e3,
                kind)
    for calls in _CENSUS:
        calls.append(call)


def rank(group=None) -> int:
    """This process's rank in the group."""
    return dist.get_rank(group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0,
               kind: str = "") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order (the
    reference's ``all_gather(..., axis=dim, tiled=True)``)."""
    x = x.contiguous()
    t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    _record("all_gather", x, t0, kind)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, op: str = "sum", group=None,
               kind: str = "") -> torch.Tensor:
    """``x`` reduced over the group with ``op`` ("sum" or "max"), in
    place; returns ``x``."""
    if not x.is_contiguous():
        raise ValueError("all_reduce reduces a contiguous tensor in place")
    t0 = time.perf_counter()
    dist.all_reduce(x, op=_OPS[op], group=group)
    _record("all_reduce_" + op, x, t0, kind)
    return x


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0,
                   kind: str = "") -> torch.Tensor:
    """This rank's block along ``dim`` of the SUM over the group of every
    rank's ``x`` (blocks in rank order)."""
    parts = [p.contiguous() for p in x.chunk(dist.get_world_size(group),
                                             dim)]
    t0 = time.perf_counter()
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    _record("reduce_scatter", x, t0, kind)
    return out


def _summed(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    return all_reduce(x.contiguous().clone(), "sum", group, kind)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group, ctx.kind), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        return _summed(x, group, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return reduce_scatter(x, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim, ctx.kind), None, None, \
            None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return all_gather(x, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim, ctx.kind), None, None, \
            None


def copy_to(x: torch.Tensor, group, kind: str = "tp") -> torch.Tensor:
    """``x`` forward; the gradient SUM all-reduced over the group."""
    return _CopyTo.apply(x, group, kind)


def reduce_from(x: torch.Tensor, group, kind: str = "tp") -> torch.Tensor:
    """The SUM over the group of every rank's ``x``; the gradient passes
    through unchanged."""
    return _ReduceFrom.apply(x, group, kind)


def gather_from(x: torch.Tensor, group, dim: int,
                kind: str = "fsdp") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; the gradient of this
    rank's slice summed over the group."""
    return _GatherFrom.apply(x, group, dim, kind)


def reduce_scatter_from(x: torch.Tensor, group, dim: int,
                        kind: str = "tp_scatter") -> torch.Tensor:
    """This rank's block along ``dim`` of the SUM over the group of every
    rank's ``x``; the gradient all-gathered along ``dim``."""
    return _ReduceScatterFrom.apply(x, group, dim, kind)


def barrier(group=None) -> None:
    """Wait until every rank of the group arrives (no payload; not in
    the census)."""
    dist.barrier(group=group)
