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

A bucket too large or too rectangular for the cubic path (the vocab
tables) routes through the §14 lowrank tier (``resolve_lowrank_tier``,
``core/lowrank.py``) when ``lowrank_rank > 0``.

``transform_bucketed`` is the same engine for matrix functions without a
pad-exactness story (Shampoo's inverse roots): exact-shape buckets only.

Sharding (DESIGN.md §8): under a mesh with a data axis larger than 1
(``mesh_batch_axes``) each bucket's batch dim is partitioned over the
ranks (``shard_over_batch``): each rank runs the chains on its own
contiguous slices, and the results are all-gathered.

Muon's local reshard (``muon_local_reshard``, DESIGN.md §4; the
reference's ``bucketing.py:390-403``): under a context whose rules map
``opt_layers`` and ``opt_rows`` to mesh axes larger than 1
(``local_reshard_axes``), a bucket built only from layer stacks splits
its slices over ``opt_layers`` (model) and the rows of its long side over
``opt_rows`` (data), padding with identity slices as
``shard_over_batch`` does (``polar_local_rows``): the grid tier's polar
then runs on the local rows with one [n, n] Gram all-reduce an iteration
(``newton_schulz.polar(row_group=)``), and the blocks are gathered back.
A bucket routed to the fused or the lowrank tier gathers its rows first
(its views enter whole) and takes the batch engine: K3, K6 and K7 have no
seam for a collective.  Outside a context the option changes nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import collectives, sharding_ctx
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


def resolve_lowrank_tier(cfg: OptimizerConfig,
                         mshape: Tuple[int, int]) -> Optional[int]:
    """Sketch width l when a bucket routes the §14 lowrank tier, None for
    the cubic (§7/§10) tiers.

    A static, batch-size-blind choice from the bucket's matrix shape.
    The tier engages when (a) it is enabled (``cfg.lowrank_rank > 0``)
    and the view crosses the size threshold — max dim above
    ``lowrank_max_dim`` or aspect ratio at least ``lowrank_aspect`` — and
    (b) projection wins: l = rank + oversample leaves a strict subspace
    (l < min(m, n)) and the modeled projected-chain FLOPs beat the cubic
    path (``kernels/ops.py``), so odd knob choices fall back to the exact
    tiers.
    """
    if not cfg.lowrank_rank:
        return None
    if cfg.matfn_method not in ("prism", "newton_schulz"):
        return None
    m, n = int(mshape[-2]), int(mshape[-1])
    hi, lo = max(m, n), min(m, n)
    if hi <= cfg.lowrank_max_dim and hi < cfg.lowrank_aspect * lo:
        return None
    l = cfg.lowrank_rank + cfg.lowrank_oversample
    if l >= lo:
        return None
    from repro_torch.kernels import ops as kops

    pcfg = cfg.resolved_prism
    it = pcfg.iterations + pcfg.warm_alpha_iters
    if kops.lowrank_polar_flops((hi, lo), l, iters=it,
                                degree=pcfg.degree) >= \
            kops.polar_flops((hi, lo), iters=it, degree=pcfg.degree):
        return None
    return l


#: telemetry encoding of the per-bucket kernel tier (the int32 "tier"
#: entry Muon carries per matrix leaf when the §14 tier is enabled)
TIER_CODES = {"grid": 0, "fused": 1, "lowrank": 2}


def resolve_tier(cfg: OptimizerConfig, mshape: Tuple[int, int]) -> str:
    """Name of the kernel tier the planner picks for a view shape:
    "lowrank" (§14) | "fused" (§10) | "grid" (§7).  Pure static-shape
    logic."""
    if resolve_lowrank_tier(cfg, mshape) is not None:
        return "lowrank"
    pcfg = resolve_fused_tier(
        cfg.resolved_prism,
        Bucket((int(mshape[-2]), int(mshape[-1])), (), 0))
    return "fused" if pcfg.use_kernels and pcfg.fuse == "on" else "grid"


# ------------------------------------------------------------------ sharding

def mesh_batch_axes(cfg: Optional[OptimizerConfig]):
    """(mesh, axes) the bucket batch dim is partitioned over, or (None,
    ()) when the engine is off.

    Active iff ``cfg.precond_shard == "auto"``, an activation-sharding
    context is installed and its mesh has a batch axis larger than 1.
    Only the data-parallel axes partition the bucket (the rules'
    ``opt_batch`` override, ``launch/sharding.py::pipeline_rules``, else
    ("pod", "data")).
    """
    if cfg is None or getattr(cfg, "precond_shard", "off") != "auto":
        return None, ()
    ctx = sharding_ctx.current()
    if ctx is None:
        return None, ()
    mesh, rules = ctx
    allowed = rules.get("opt_batch", ("pod", "data"))
    axes = tuple(a for a in allowed
                 if a in mesh.axis_names and mesh.shape[a] > 1)
    return (mesh, axes) if axes else (None, ())


def shard_over_batch(fn: Callable, mesh, axes: Tuple[str, ...],
                     stacked: torch.Tensor,
                     slice_args: Sequence[torch.Tensor] = (),
                     slice_pads: Sequence = ()):
    """``fn(stacked, *slice_args)`` with the leading batch dim partitioned
    over the mesh ``axes``: each rank runs ``fn`` on its contiguous rows,
    and every output (an array, or the §11 tuple of batch-leading
    arrays) is all-gathered and un-padded.

    ``slice_args`` are per-slice companions [B, ...] (the ``n_real``
    trace correction) that shard with the batch; ``slice_pads`` gives
    each one's fill when B pads up to a multiple of the shard count.  The
    batch pads with identity slices: every chain normalizes and fits per
    slice, so pad slices run finite chains of their own and are sliced
    away after the gather.  §11's adaptive loop runs per rank: each rank
    iterates until its own slowest slice certifies.
    """
    group = mesh.group(axes)
    n = math.prod(mesh.shape[a] for a in axes)
    B, M, N = stacked.shape
    pad = (-B) % n
    if pad:
        eye = torch.eye(M, N, dtype=stacked.dtype, device=stacked.device)
        stacked = torch.cat([stacked, eye.expand(pad, M, N)], dim=0)
        slice_args = [
            torch.cat([s, torch.full((pad,) + tuple(s.shape[1:]), v,
                                     dtype=s.dtype, device=s.device)])
            for s, v in zip(slice_args, slice_pads)]
    per = (B + pad) // n
    lo = collectives.rank(group) * per
    out = fn(stacked[lo:lo + per], *(s[lo:lo + per] for s in slice_args))
    if isinstance(out, tuple):
        return tuple(collectives.all_gather(o, group, kind="engine")[:B]
                     for o in out)
    return collectives.all_gather(out, group, kind="engine")[:B]


def local_reshard_axes(cfg: Optional[OptimizerConfig]):
    """(mesh, slice axes, row axes) of Muon's local reshard, or None when
    it is off: ``cfg.muon_local_reshard``, a context installed, and its
    rules' ``opt_layers``/``opt_rows`` naming mesh axes larger than 1."""
    if cfg is None or not getattr(cfg, "muon_local_reshard", False):
        return None
    ctx = sharding_ctx.current()
    if ctx is None:
        return None
    mesh, rules = ctx
    from repro_torch.launch.sharding import axes_of

    def live(rule):
        named = axes_of(rules.get(rule))
        return tuple(a for a in mesh.axis_names
                     if a in named and mesh.shape[a] > 1)

    slices, rows = live("opt_layers"), live("opt_rows")
    return (mesh, slices, rows) if slices or rows else None


def polar_local_rows(fn: Callable, mesh, slice_axes: Tuple[str, ...],
                     row_axes: Tuple[str, ...], stacked: torch.Tensor,
                     slice_args: Sequence[torch.Tensor] = (),
                     slice_pads: Sequence = ()):
    """``fn(x, *slice_args, row_group=)`` on this rank's block of a [B, M,
    N] bucket: its slices of ``slice_axes`` and its rows of the long side
    of ``row_axes``; every output is gathered back whole (the rows over
    ``row_axes``, then the slices over ``slice_axes``).  The batch pads
    with identity slices to a multiple of the slice ranks; the companions
    pad with ``slice_pads``.  Returns None when the long side does not
    split over the row ranks (the caller takes the batch engine)."""
    ns = math.prod(mesh.shape[a] for a in slice_axes)
    nr = math.prod(mesh.shape[a] for a in row_axes)
    B, M, N = stacked.shape
    flip = M < N
    x = stacked.transpose(-1, -2) if flip else stacked
    long_side = x.shape[-2]
    if long_side % nr:
        return None
    pad = (-B) % ns
    if pad:
        eye = torch.eye(x.shape[-2], x.shape[-1], dtype=x.dtype,
                        device=x.device)
        x = torch.cat([x, eye.expand(pad, *eye.shape)], dim=0)
        slice_args = [
            torch.cat([s, torch.full((pad,) + tuple(s.shape[1:]), v,
                                     dtype=s.dtype, device=s.device)])
            for s, v in zip(slice_args, slice_pads)]
    per, rows = (B + pad) // ns, long_side // nr
    sg = mesh.group(slice_axes) if slice_axes else None
    rg = mesh.group(row_axes) if row_axes else None
    si = collectives.rank(sg) if sg is not None else 0
    ri = collectives.rank(rg) if rg is not None else 0
    block = x[si * per:(si + 1) * per, ri * rows:(ri + 1) * rows]
    out = fn(block.contiguous(),
             *(s[si * per:(si + 1) * per] for s in slice_args), row_group=rg)
    outs = out if isinstance(out, tuple) else (out,)
    whole = []
    for j, o in enumerate(outs):
        if j == 0 and rg is not None:  # the polar's rows
            o = collectives.all_gather(o, rg, dim=1, kind="engine")
        if sg is not None:
            o = collectives.all_gather(o, sg, kind="engine")
        o = o[:B]
        whole.append(o.transpose(-1, -2) if j == 0 and flip else o)
    return tuple(whole) if isinstance(out, tuple) else whole[0]


def polar_bucketed(views: Sequence[torch.Tensor], cfg: OptimizerConfig,
                   key=None, with_iters: bool = False):
    """Polar factor of every matrix view via one batched call per bucket,
    gathered directly in the engine's compute dtype (``matfn_dtype``) —
    the SVD method excepted, whose LAPACK path is pinned fp32: its buckets
    gather as they come (fp32 momentum) and are never padded.

    ``key`` is the step's sketch key; bucket ``bi`` draws from
    ``key.fold_in(bi)``.  A bucket that ``resolve_lowrank_tier`` routes
    runs ``lowrank.polar_lowrank`` (no ``n_real``: its chains live on the
    never-padded l side; the fused-tier choice resolves inside its inner
    polars from their [m, l] / [l, n] shapes).  ``with_iters`` (the NS
    family only: methods prism and newton_schulz) also returns per-view
    ``iters_used`` and guardian ``status`` (DESIGN.md §11/§15), scattered
    back to each view's lead shape: (outs, iters, statuses).  With
    ``muon_local_reshard`` under a context, a grid-tier bucket of layer
    stacks runs ``polar_local_rows`` (module docstring).
    """
    method = cfg.matfn_method
    if with_iters and method not in ("prism", "newton_schulz"):
        raise ValueError(f"with_iters needs an NS-family method, not "
                         f"{method!r}")
    pcfg = cfg.resolved_prism
    compute = None if method == "svd" else \
        cfg.matfn_precision.compute_dtype
    buckets = plan_buckets([tuple(v.shape) for v in views],
                           pad=cfg.bucket_pad and method != "svd",
                           pad_slack=cfg.bucket_pad_slack)
    mesh, mesh_axes = mesh_batch_axes(cfg)
    reshard = local_reshard_axes(cfg)
    outs: List[Optional[torch.Tensor]] = [None] * len(views)
    iters: List[Optional[torch.Tensor]] = [None] * len(views)
    statuses: List[Optional[torch.Tensor]] = [None] * len(views)
    for bi, b in enumerate(buckets):
        stacked = gather_bucket(b, views, dtype=compute)
        kk = key.fold_in(bi) if key is not None else None
        kw = {}
        if with_iters:
            kw.update(return_iters=True, return_status=True)
        n_real = ()
        local = None
        if resolve_lowrank_tier(cfg, b.shape) is not None:
            from repro_torch.core import lowrank

            def run(x):
                return lowrank.polar_lowrank(x, cfg.lowrank_rank,
                                             cfg.lowrank_oversample,
                                             cfg=pcfg, key=kk,
                                             method=method, **kw)
        else:
            pcfg_b = resolve_fused_tier(pcfg, b)
            if b.padded and method == "prism":
                n_real = (_gram_real_dims(b, stacked.device),)

            def run(x, *nr, row_group=None):
                extra = {"n_real": nr[0]} if nr else {}
                if row_group is not None:
                    extra["row_group"] = row_group
                return matfn.polar(x, method=method, cfg=pcfg_b, key=kk,
                                   **kw, **extra)

            grid = not (pcfg_b.use_kernels and pcfg_b.fuse == "on")
            if reshard is not None and grid and \
                    method in ("prism", "newton_schulz") and \
                    all(e.lead for e in b.entries):
                local = polar_local_rows(run, *reshard, stacked, n_real,
                                         (min(b.shape),) * len(n_real))
        if local is not None:
            O = local
        elif mesh is not None:
            # pad slices carry no intra-slice pad: their n_real is full
            O = shard_over_batch(run, mesh, mesh_axes, stacked, n_real,
                                 (min(b.shape),) * len(n_real))
        else:
            O = run(stacked, *n_real)
        if with_iters:
            O, it, st = O
            scatter_bucket_aux(b, it, iters)
            scatter_bucket_aux(b, st, statuses)
        scatter_bucket(b, O, outs)
    if with_iters:
        return outs, iters, statuses
    return outs  # type: ignore[return-value]


def polar_refresh(views: Sequence[torch.Tensor], cfg: OptimizerConfig,
                  key=None):
    """The Muon preconditioner refresh as one callable (DESIGN.md §12):
    the polar factor of every view, as ``(outs, iters, statuses)`` with
    the last two None unless ``cfg.matfn_telemetry``.  Bucketed, it is
    ``polar_bucketed``; otherwise one polar a view, view ``i`` drawing
    from ``key.fold_in(i)``, ``i`` its position among ``views`` (the
    reference's, which is not the leaf index the in-step per-leaf loop
    folds in)."""
    tele = cfg.matfn_telemetry
    if cfg.bucketed:
        if tele:
            return polar_bucketed(views, cfg, key, with_iters=True)
        return polar_bucketed(views, cfg, key), None, None
    kw = dict(return_iters=True, return_status=True) if tele else {}
    outs = [matfn.polar(M, method=cfg.matfn_method, cfg=cfg.resolved_prism,
                        key=key.fold_in(i) if key is not None else None,
                        **kw)
            for i, M in enumerate(views)]
    if tele:
        return tuple(list(t) for t in zip(*outs))
    return outs, None, None


def transform_bucketed(mats: Sequence[torch.Tensor], fn,
                       cfg: Optional[OptimizerConfig] = None,
                       with_aux: int = 0):
    """Apply ``fn(stacked, bucket, bucket_index)`` once per exact-shape
    bucket and scatter the [B, n, n] results back.

    ``with_aux``: N > 0 when fn returns (out [B, n, n], aux_1 [B], ...,
    aux_N [B]), per-slice companions scattered back alongside; returns
    (outs, auxs_1, ..., auxs_N).  Gathers stay fp32 (the stacked arrays
    are Shampoo's fp32 EMA Kronecker factors, whose eps-ridge must apply
    in fp32 before the chain casts down, DESIGN.md §9): fn owns the cast.
    fn must be per-slice (elementwise over the batch dim) and may use the
    bucket and its index only for static metadata (shape, key folding):
    with a ``cfg`` and an active mesh (``mesh_batch_axes``) its
    ``stacked`` is a rank's own, possibly identity-padded, rows of the
    bucket (identity slices are SPD, so inverse-root chains on them stay
    finite).  The fused tier resolves inside the iteration family from
    the bucket shape.
    """
    n_aux = int(with_aux)
    buckets = plan_buckets([tuple(m.shape) for m in mats], pad=False)
    mesh, mesh_axes = mesh_batch_axes(cfg)
    outs: List[Optional[torch.Tensor]] = [None] * len(mats)
    auxs = [[None] * len(mats) for _ in range(n_aux)]
    for bi, b in enumerate(buckets):
        stacked = gather_bucket(b, mats)
        if mesh is not None:
            out = shard_over_batch(lambda x: fn(x, b, bi), mesh,
                                   mesh_axes, stacked)
        else:
            out = fn(stacked, b, bi)
        if n_aux:
            out, *aux = out
            for k in range(n_aux):
                scatter_bucket_aux(b, aux[k], auxs[k])
        scatter_bucket(b, out, outs)
    if n_aux:
        return (outs, *auxs)
    return outs
