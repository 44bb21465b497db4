"""Shape-bucketed batched matrix-function engine (DESIGN.md §7; counterpart
of ``repro/optim/bucketing.py``).

Muon calls ``matfn.polar`` once per parameter matrix; this module collapses
that dispatch:

  1. ``plan_buckets`` partitions the matrix views of a param tree into
     shape buckets — exact-shape groups, plus (optionally) near-miss
     shapes merged into a shared padded bucket;
  2. ``gather_bucket`` stacks each bucket into ONE [B, m, n] tensor
     (leading stacked-layer dims of a view flatten into B, near-miss
     shapes zero-pad to the bucket shape);
  3. one batched polar call runs per bucket — with ``use_kernels`` a
     constant number of kernel launches per iteration, independent of B;
  4. ``scatter_bucket`` splits, un-pads and reshapes the results back.

Zero-padding is exact for the Newton-Schulz polar iterations (pad rows
and columns of X stay zero), and the sketched alpha fit is made exactly
pad-blind by the ``n_real`` trace correction (``prism.fit_alpha``).  Each
bucket draws its sketches from the step's key folded with the bucket's
index, as in the reference.  The plan is pure Python over static shapes.

``transform_bucketed`` is the same engine for matrix functions without a
pad-exactness story (Shampoo's inverse roots): exact-shape buckets only.

Not ported yet: mesh sharding over the batch dim (``shard_over_batch``)
and the lowrank tier (ROADMAP.md Queue 1 items 7, 11).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.core import matfn


class Entry(NamedTuple):
    """One matrix view's slot inside a bucket."""

    index: int                  # position in the caller's list of views
    lead: Tuple[int, ...]       # leading (stacked-layer) dims of the view
    mshape: Tuple[int, int]     # real matrix shape (m, n)
    offset: int                 # first slice in the bucket's batch dim

    @property
    def count(self) -> int:
        c = 1
        for d in self.lead:
            c *= d
        return c


class Bucket(NamedTuple):
    shape: Tuple[int, int]      # bucket (possibly padded-to) matrix shape
    entries: Tuple[Entry, ...]
    size: int                   # total stacked batch B

    @property
    def padded(self) -> bool:
        return any(e.mshape != self.shape for e in self.entries)


def plan_buckets(shapes: Sequence[Tuple[int, ...]], *, pad: bool = False,
                 pad_slack: float = 0.25) -> Tuple[Bucket, ...]:
    """Partition view shapes [..lead.., m, n] into shape buckets.

    Exact (m, n) groups never mix orientations.  With ``pad``, a shape
    joins an existing larger bucket target (M, N) when padding is needed
    ONLY on the target's Gram side (cols when M >= N, else rows) and the
    padded area stays within M*N <= (1 + pad_slack) * m*n; targets are
    seeded from the largest shapes first so the merge is deterministic.
    """
    mshapes = [(int(s[-2]), int(s[-1])) for s in shapes]
    distinct = sorted(set(mshapes), key=lambda s: (-s[0] * s[1], s))
    target = {}
    targets: List[Tuple[int, int]] = []
    for m, n in distinct:
        tgt = (m, n)
        if pad:
            for M, N in targets:
                fits = (m == M and n <= N) if M >= N else \
                    (n == N and m <= M)
                if fits and M * N <= (1 + pad_slack) * m * n:
                    tgt = (M, N)
                    break
        target[(m, n)] = tgt
        if tgt == (m, n):
            targets.append(tgt)
    groups = {}
    for i, s in enumerate(shapes):
        groups.setdefault(target[mshapes[i]], []).append(i)
    buckets = []
    for tgt in sorted(groups):
        entries, offset = [], 0
        for i in groups[tgt]:
            e = Entry(i, tuple(int(d) for d in shapes[i][:-2]),
                      mshapes[i], offset)
            entries.append(e)
            offset += e.count
        buckets.append(Bucket(tgt, tuple(entries), offset))
    return tuple(buckets)


def gather_bucket(bucket: Bucket, views: Sequence[torch.Tensor],
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stack a bucket's views into one [B, M, N] tensor (zero-padded),
    cast to ``dtype`` before stacking (DESIGN.md §9)."""
    M, N = bucket.shape
    parts = []
    for e in bucket.entries:
        v = views[e.index]
        if dtype is not None and v.dtype != dtype:
            v = v.to(dtype)
        v = v.reshape((e.count,) + e.mshape)
        pm, pn = M - e.mshape[0], N - e.mshape[1]
        if pm or pn:
            v = torch.nn.functional.pad(v, (0, pn, 0, pm))
        parts.append(v)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def scatter_bucket(bucket: Bucket, batch: torch.Tensor,
                   outs: List[Optional[torch.Tensor]]) -> None:
    """Split [B, M, N] results back into per-view tensors (in place)."""
    for e in bucket.entries:
        m, n = e.mshape
        sl = batch[e.offset:e.offset + e.count, :m, :n]
        outs[e.index] = sl.reshape(e.lead + e.mshape)


def scatter_bucket_aux(bucket: Bucket, aux: torch.Tensor,
                       outs: List[Optional[torch.Tensor]]) -> None:
    """Split a per-slice companion [B, ...] (e.g. the §11 ``iters_used``
    telemetry) back into per-view tensors of the views' lead shapes."""
    for e in bucket.entries:
        sl = aux[e.offset:e.offset + e.count]
        outs[e.index] = sl.reshape(e.lead + tuple(sl.shape[1:]))


def _gram_real_dims(bucket: Bucket, device) -> torch.Tensor:
    """Per-slice real extent of the polar Gram dimension, int32 [B].

    ``newton_schulz.polar`` transposes when M < N, so the Gram residual
    lives on the min side of the BUCKET shape; each slice's real extent on
    that side feeds the n_real trace correction.  Built on ``device`` with
    fills, so no host-to-device copy is needed.
    """
    M, N = bucket.shape
    side = 1 if M >= N else 0
    return torch.cat([torch.full((e.count,), e.mshape[side],
                                 dtype=torch.int32, device=device)
                      for e in bucket.entries])


def resolve_fused_tier(pcfg: PrismConfig, bucket: Bucket) -> PrismConfig:
    """Pin the fused-iteration tier (DESIGN.md §10) for one bucket from its
    static matrix shape against the shared-memory model; batch-size
    independent.  "auto" resolves to an explicit "on"/"off"; forced
    values pass through."""
    if pcfg.fuse != "auto" or not pcfg.use_kernels:
        return pcfg
    from repro_torch.kernels import ops as kops

    m, n = bucket.shape
    mshape = (max(m, n), min(m, n))  # polar transposes to m >= n
    fits = kops.fused_fits(mshape, pcfg.dtype, budget=pcfg.vmem_budget,
                           sketch_dim=pcfg.sketch_dim)
    return dataclasses.replace(pcfg, fuse="on" if fits else "off")


def resolve_tier(cfg: OptimizerConfig, mshape: Tuple[int, int]) -> str:
    """Name of the kernel tier the planner picks for a view shape:
    "fused" (§10) | "grid" (§7).  Pure static-shape logic."""
    if cfg.lowrank_rank:
        raise NotImplementedError(
            "the lowrank tier (OptimizerConfig.lowrank_rank) is ported "
            "with ROADMAP.md Queue 1 item 7")
    pcfg = resolve_fused_tier(
        cfg.resolved_prism,
        Bucket((int(mshape[-2]), int(mshape[-1])), (), 0))
    return "fused" if pcfg.use_kernels and pcfg.fuse == "on" else "grid"


def polar_bucketed(views: Sequence[torch.Tensor], cfg: OptimizerConfig,
                   key=None, with_iters: bool = False):
    """Polar factor of every matrix view via one batched call per bucket,
    gathered directly in the engine's compute dtype (``matfn_dtype``).

    ``key`` is the step's sketch key; bucket ``bi`` draws from
    ``key.fold_in(bi)``.  ``with_iters`` also returns per-view
    ``iters_used`` and guardian ``status`` (DESIGN.md §11/§15), scattered
    back to each view's lead shape: (outs, iters, statuses).
    """
    method = cfg.matfn_method
    if cfg.lowrank_rank:
        raise NotImplementedError(
            "the lowrank tier (OptimizerConfig.lowrank_rank) is ported "
            "with ROADMAP.md Queue 1 item 7")
    pcfg = cfg.resolved_prism
    compute = cfg.matfn_precision.compute_dtype
    buckets = plan_buckets([tuple(v.shape) for v in views],
                           pad=cfg.bucket_pad,
                           pad_slack=cfg.bucket_pad_slack)
    outs: List[Optional[torch.Tensor]] = [None] * len(views)
    iters: List[Optional[torch.Tensor]] = [None] * len(views)
    statuses: List[Optional[torch.Tensor]] = [None] * len(views)
    for bi, b in enumerate(buckets):
        stacked = gather_bucket(b, views, dtype=compute)
        kw = {}
        if b.padded and method == "prism":
            kw["n_real"] = _gram_real_dims(b, stacked.device)
        if with_iters:
            kw.update(return_iters=True, return_status=True)
        O = matfn.polar(stacked, method=method,
                        cfg=resolve_fused_tier(pcfg, b),
                        key=key.fold_in(bi) if key is not None else None,
                        **kw)
        if with_iters:
            O, it, st = O
            scatter_bucket_aux(b, it, iters)
            scatter_bucket_aux(b, st, statuses)
        scatter_bucket(b, O, outs)
    if with_iters:
        return outs, iters, statuses
    return outs  # type: ignore[return-value]


def transform_bucketed(mats: Sequence[torch.Tensor], fn,
                       with_aux: int = 0):
    """Apply ``fn(stacked, bucket, bucket_index)`` once per exact-shape
    bucket and scatter the [B, n, n] results back.

    ``with_aux``: N > 0 when fn returns (out [B, n, n], aux_1 [B], ...,
    aux_N [B]), per-slice companions scattered back alongside; returns
    (outs, auxs_1, ..., auxs_N).  Gathers stay fp32 (the stacked arrays
    are Shampoo's fp32 EMA Kronecker factors, whose eps-ridge must apply
    in fp32 before the chain casts down, DESIGN.md §9): fn owns the cast.
    fn must be per-slice (elementwise over the batch dim) and may use the
    bucket and its index only for static metadata (shape, key folding).
    The fused tier resolves inside the iteration family from the bucket
    shape.  The reference's ``cfg`` argument, which shards the batch dim
    over a mesh, is ported with ROADMAP.md Queue 1 item 11.
    """
    n_aux = int(with_aux)
    buckets = plan_buckets([tuple(m.shape) for m in mats], pad=False)
    outs: List[Optional[torch.Tensor]] = [None] * len(mats)
    auxs = [[None] * len(mats) for _ in range(n_aux)]
    for bi, b in enumerate(buckets):
        out = fn(gather_bucket(b, mats), b, bi)
        if n_aux:
            out, *aux = out
            for k in range(n_aux):
                scatter_bucket_aux(b, aux[k], auxs[k])
        scatter_bucket(b, out, outs)
    if n_aux:
        return (outs, *auxs)
    return outs
