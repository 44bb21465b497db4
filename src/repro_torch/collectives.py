"""The port's collectives, in one place and counted.

Every collective the port issues goes through this module: ``all_gather``
over a mesh's batch axes (the §8 engine, DESIGN.md §8) and ``all_reduce``
with SUM or MAX (the data-parallel gradient and metric averages,
``optim/compression.py::int8_psum``).  Each call appends its op, dtype,
element count and host time to the census that ``count_collectives``
opens, as ``kernels/ops.py::count_launches`` counts kernel launches.

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
    """One collective: ``op`` is "all_gather", "all_reduce_sum" or
    "all_reduce_max"; ``numel`` the elements this rank contributed."""

    op: str
    dtype: torch.dtype
    numel: int
    ms: float

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


def _record(op: str, x: torch.Tensor, t0: float) -> None:
    call = Call(op, x.dtype, x.numel(), (time.perf_counter() - t0) * 1e3)
    for calls in _CENSUS:
        calls.append(call)


def rank(group=None) -> int:
    """This process's rank in the group."""
    return dist.get_rank(group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order (the
    reference's ``all_gather(..., axis=0, tiled=True)``)."""
    x = x.contiguous()
    t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    _record("all_gather", x, t0)
    return torch.cat(parts, dim=0)


def all_reduce(x: torch.Tensor, op: str = "sum",
               group=None) -> torch.Tensor:
    """``x`` reduced over the group with ``op`` ("sum" or "max"), in
    place; returns ``x``."""
    if not x.is_contiguous():
        raise ValueError("all_reduce reduces a contiguous tensor in place")
    t0 = time.perf_counter()
    dist.all_reduce(x, op=_OPS[op], group=group)
    _record("all_reduce_" + op, x, t0)
    return x


def barrier(group=None) -> None:
    """Wait until every rank of the group arrives (no payload; not in
    the census)."""
    dist.barrier(group=group)
