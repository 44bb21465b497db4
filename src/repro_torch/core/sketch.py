"""Randomized sketching primitives (counterpart of ``repro/core/sketch.py``).

A Gaussian S in R^{p x n} with i.i.d. N(0, 1/p) entries is an oblivious
subspace embedding; PRISM only needs the sketched power traces

    t_i = tr(S R^i S^T),  i = 0..max_power,

computed by the chained products V_i = R V_{i-1} with V_0 = S^T, at a
cost of O(n^2 p max_power).  All functions broadcast over leading batch
dimensions of R ([..., n, n]; S is [p, n], shared across the batch).
"""
from __future__ import annotations

from typing import Union

import torch


def gaussian_sketch(key, p: int, n: int, dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cpu"
                    ) -> torch.Tensor:
    """S in R^{p x n} with i.i.d. N(0, 1/p) entries, drawn from ``key``
    (``core.rng.Key`` or anything with its ``normal`` method) on
    ``device``.  The division by sqrt(p) runs in ``dtype``, with sqrt(p)
    itself rounded to ``dtype``, as in the reference."""
    sqrt_p = float(torch.sqrt(torch.tensor(float(p), dtype=dtype)))
    return key.normal((p, n), dtype, device) / sqrt_p


def sketched_power_traces(R: torch.Tensor, S: torch.Tensor, max_power: int,
                          use_kernels: bool = False,
                          vmem_budget: int = 0) -> torch.Tensor:
    """t_i = tr(S R^i S^T) for i = 0..max_power, fp32, [..., max_power+1].

    ``use_kernels`` routes the chain through ``kernels.ops.sketch_traces``
    (K5, or a loop of K4 when the chain does not fit one block's shared
    memory; ``vmem_budget`` overrides that budget in bytes).  Otherwise
    the chain runs as torch products with the kernels' accumulation
    order (DESIGN.md §9): each R @ V accumulates fp32, the trace reduces
    the fp32 accumulator (not the rounded V'), and only the V that feeds
    the next power rounds to the compute dtype.
    """
    if use_kernels:
        from repro_torch.kernels import ops as kops

        return kops.sketch_traces(R, S, max_power, budget=vmem_budget)
    from repro_torch.kernels import ref as kref

    return kref.sketch_traces(R, S, max_power)


def exact_power_traces(R: torch.Tensor, max_power: int) -> torch.Tensor:
    """Unsketched t_i = tr(R^i) (the paper's Eq. (3) objective); O(n^3).
    fp32 accumulation and trace, powers rounded to R's dtype in between."""
    n = R.shape[-1]
    lead = R.shape[:-2]
    P = torch.eye(n, dtype=R.dtype, device=R.device).expand(R.shape)
    traces = [torch.full(lead, float(n), dtype=torch.float32,
                         device=R.device)]
    for _ in range(max_power):
        Pacc = torch.matmul(R.float(), P.float())
        traces.append(torch.diagonal(Pacc, dim1=-2, dim2=-1).sum(-1))
        P = Pacc.to(R.dtype)
    return torch.stack(traces, dim=-1)
