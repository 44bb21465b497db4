"""Optimizer utilities shared by the port's optimizers (counterpart of
``repro/optim/base.py``): global-norm clipping, the matrix views Muon and
Shampoo precondition, the refresh period, Adam's bias corrections and the
§15 skip-step guard.

The reference's functional ``Optimizer(init, update, refresh)`` contract
becomes ``torch.optim.Optimizer`` subclasses (``muon.Muon``,
``shampoo.Shampoo``, ``adamw.AdamW``): ``init`` is the per-parameter
``state`` each creates in its constructor, ``update`` is
``step(key=, refresh=)``, and the reference's ``state["count"]`` is the
optimizer's ``count``, a host int (a device tensor under
``skip_nonfinite``).

The §12 async refresh plane (DESIGN.md §12, §15) lives here too: the
pending-buffer helpers (``install_pending``, ``discard_pending``,
``precond_drift``, ...) and the ``AsyncPrecondService`` that dispatches
an optimizer's refresh between steps, on a side CUDA stream on the card.
The reference's ``refresh(state, key)`` becomes the optimizer's
``refresh(key)``: one partial dict per parameter, in
``param_groups[0]["params"]`` order, and its root ``state["pending_at"]``
the optimizer's ``pending_at`` (a host int; a device int32 under
``skip_nonfinite``).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

#: the per-parameter state keys of the §12 async refresh plane's pending
#: twins: checkpoints drop them (``checkpoint.save(drop=)``) and a
#: restore keeps the target's own value (then ``discard_pending``)
PENDING_STATE_KEYS = frozenset({
    "ortho_p", "Linv_p", "Rinv_p",
    "iters_p", "Linv_iters_p", "Rinv_iters_p",
    "status_p", "Linv_status_p", "Rinv_status_p",
})

#: ``pending_at`` meaning "no refresh in flight".  A large negative
#: sentinel rather than -1: the bootstrap dispatch BACK-DATES
#: ``pending_at = step - precond_swap_delay`` (possibly negative) so that
#: its swap fires on the dispatching step itself.
NO_PENDING = -(1 << 30)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32."""
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t.float()))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale grads (as fp32) so their global norm (``norm`` when given:
    the norm of the whole gradients a rank holds blocks of) is at most
    ``max_norm``.

    Guarded (§15): a zero set keeps scale 1 instead of dividing by zero,
    and a NON-FINITE global norm passes the gradients through UNSCALED, so
    one inf entry does not turn into an all-zero or all-NaN step.  Returns
    (clipped grads, raw global norm)."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.where(torch.isfinite(gn),
                        torch.clamp(max_norm / torch.clamp(gn, min=1e-12),
                                    max=1.0),
                        torch.ones_like(gn))
    return [g.float() * scale for g in grads], gn


def resolve_refresh_period(cfg, name: Optional[str] = None) -> int:
    """Effective preconditioner refresh period K of one optimizer: Muon
    refreshes every ``precond_every`` steps; Shampoo also honours its
    legacy ``precondition_every``, so its period is the max of the two.
    ``name`` overrides ``cfg.name``."""
    name = cfg.name if name is None else name
    k = max(1, int(cfg.precond_every))
    if name == "shampoo":
        k = max(k, int(cfg.precondition_every))
    return k


class Blocks:
    """The layout of an optimizer's state on a sharded model (every
    optimizer's ``blocks``; DESIGN.md §4, §8) over named parameters and
    their ``shardings`` (name -> ``launch.sharding.Sharding``; a missing
    or unsplit one is whole).

    ``param[i]`` is parameter i's Sharding (None: whole), ``full_shapes[i]``
    its whole shape, ``mesh`` and ``coords`` the mesh and this rank's
    place on it (None without a split parameter), and ``layouts[i]`` the
    Sharding of every state entry of parameter i that is held as a block:
    the moments like their parameter (``like_param``), the cached
    preconditioners and their §12 twins as their ``precond_cache_sharding``
    blocks of the whole cache (``cache``).  Without a mesh every method is
    the identity and no collective runs."""

    def __init__(self, named, shardings=None):
        from repro_torch.launch import sharding

        shardings = shardings or {}
        self.param = [shardings.get(n) if sharding.sharded_axes(
            shardings.get(n)) else None for n, _ in named]
        self.full_shapes = [sharding.full_shape(tuple(p.shape), sh)
                            for (_, p), sh in zip(named, self.param)]
        split = [sh for sh in self.param if sh is not None]
        self.mesh = split[0].mesh if split else None
        self.coords = self.mesh.coords() if split else None
        self.layouts: List[dict] = [{} for _ in named]

    def like_param(self, i: int, *keys: str) -> None:
        """State entries ``keys`` of parameter i are blocks like it."""
        if self.param[i] is not None:
            for k in keys:
                self.layouts[i][k] = self.param[i]

    def cache(self, i: int, keys, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Hold the state entries ``keys`` of parameter i (a cache of the
        whole shape ``shape`` and its twin) as their
        ``precond_cache_sharding`` blocks; returns the block's shape."""
        if self.mesh is None:
            return tuple(shape)
        from repro_torch.launch import sharding

        sh = sharding.precond_cache_sharding(self.mesh, tuple(shape))
        for k in keys:
            self.layouts[i][k] = sh
        return sharding.local_shape(tuple(shape), sh)

    def block(self, x: torch.Tensor, i: int, key: str) -> torch.Tensor:
        """This rank's block of the whole ``x`` under entry ``key``'s
        layout, in memory of its own (``x`` itself when it is whole)."""
        sh = self.layouts[i].get(key)
        if sh is None:
            return x
        from repro_torch.launch import sharding

        return sharding.local_block(x, sh, self.coords).clone(
            memory_format=torch.contiguous_format)

    def whole(self, x: torch.Tensor, i: int, key: str,
              kind: str = "cache") -> torch.Tensor:
        """The whole entry from every rank's block ``x`` of entry ``key``
        (collective on a mesh; ``x`` itself when it is whole)."""
        sh = self.layouts[i].get(key)
        if sh is None:
            return x
        from repro_torch.launch import sharding

        return sharding.gather_full(x, sh, kind=kind)

    def world_sums(self, sums: List[torch.Tensor], idx: List[int]
                   ) -> List[torch.Tensor]:
        """The whole leaves' sums from each rank's block sums (0-d fp32;
        ``sums[j]`` of parameter ``idx[j]``'s block): each counted on the
        ranks at coordinate 0 of the axes its parameter is replicated
        over, one SUM all-reduce over the world (kind "drift")."""
        if self.mesh is None or not sums:
            return sums
        from repro_torch import collectives
        from repro_torch.launch import sharding

        mesh = self.mesh
        vec = []
        for s, i in zip(sums, idx):
            split = sharding.sharded_axes(self.param[i])
            owner = all(self.coords[a] == 0 for a in mesh.axis_names
                        if a not in split)
            vec.append(s if owner else torch.zeros_like(s))
        vec = torch.stack(vec)
        collectives.all_reduce(vec, "sum", mesh.group(mesh.axis_names),
                               kind="drift")
        return list(vec.unbind())

    def world_all(self, ok: torch.Tensor) -> torch.Tensor:
        """A 0-d bool true on every rank iff it is true on every rank of
        the world (one MAX all-reduce, kind "verdict"; ``ok`` itself
        without a mesh).  Stays on the device."""
        if self.mesh is None:
            return ok
        from repro_torch import collectives

        bad = (~ok).to(torch.int32).reshape(1)
        collectives.all_reduce(bad, "max",
                               self.mesh.group(self.mesh.axis_names),
                               kind="verdict")
        return bad[0] == 0


def adam_bias_corrections(b1: float, b2: float, count):
    """(1 - b1**t, 1 - b2**t) for t = count + 1, Adam's bias corrections.

    A host ``count`` gives Python floats; a device ``count`` (under
    ``skip_nonfinite``) gives fp32 device scalars, so nothing is read back
    to the host."""
    if isinstance(count, torch.Tensor):
        t = (count + 1).float()
        return 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
    t = float(count + 1)
    return 1 - b1 ** t, 1 - b2 ** t


class SkipNonfinite:
    """§15 skip-step guard around an optimizer (``skip_nonfinite``).

    A non-finite gradient would contaminate the momentum and EMA
    accumulators for good (0 * NaN is NaN).  Each ``step`` therefore
    snapshots the parameters and the whole state, lets the inner
    optimizer propose its update, and commits every buffer with
    ``torch.where(ok, new, old)``, where ``ok`` is ONE fused finiteness
    flag on the device over the gradients and the proposed parameters.
    Nothing is read back to the host: the inner step makes the same
    launches either way, and no branch waits on the device.

    ``bad_steps`` (a device int32) advances on a skipped step; ``count``
    (the inner optimizer's, made a device int32 here so that it can roll
    back) does not.  The refresh schedule of a period K > 1 cannot read
    that device count without a synchronization, so the guard keeps a
    host clock of its own (the steps taken) and passes the inner step an
    explicit ``refresh = clock % K == 0`` when the caller gives none;
    after a skipped step it runs one step ahead of ``count``.  The
    Trainer always passes ``refresh``.  Everything else (``state``,
    ``param_groups``, ``cfg``) is the inner optimizer's.

    Under the §12 refresh plane the root ``pending_at`` is a device int32
    too, rolled back with the rest; the swap is then decided on the
    device (``swap_pending``), from the step the clock allows on.  The
    pending twins are left out of the snapshot: a step never writes
    them, and the refresh that made them may still be running on its
    side stream.
    """

    def __init__(self, opt):
        self.opt = opt
        dev = opt.param_groups[0]["params"][0].device
        self.bad_steps = torch.zeros((), dtype=torch.int32, device=dev)
        self.clock = 0
        self.count = opt.count
        if hasattr(opt, "pending_at"):
            opt.pending_at = torch.full((), int(opt.pending_at),
                                        dtype=torch.int32, device=dev)

    def __getattr__(self, name):
        if name == "opt":  # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.opt, name)

    @property
    def count(self):
        return self.opt.count

    @count.setter
    def count(self, value) -> None:
        """Set the step count (a restore): the host clock follows it."""
        self.clock = int(value)
        dev = self.opt.param_groups[0]["params"][0].device
        self.opt.count = torch.full((), self.clock, dtype=torch.int32,
                                    device=dev)

    @torch.no_grad()
    def step(self, closure=None, key=None, refresh=None):
        if closure is not None:
            raise ValueError("SkipNonfinite.step takes no closure")
        opt = self.opt
        params = opt.param_groups[0]["params"]
        period = resolve_refresh_period(opt.cfg)
        if refresh is None and period > 1:
            refresh = self.clock % period == 0
        old_p = [p.detach().clone() for p in params]
        old_s = [{k: v.clone() for k, v in opt.state[p].items()
                  if k not in PENDING_STATE_KEYS} for p in params]
        old_count = opt.count.clone()
        old_pending = getattr(opt, "pending_at", None)
        opt.host_count = self.clock
        opt.step(key=key, refresh=refresh)
        checks = [p.grad for p in params if p.grad is not None] + params
        ok = torch.stack([torch.isfinite(t).all() for t in checks]).all()
        # blocks of a sharded model: every rank commits or rolls back
        ok = opt.blocks.world_all(ok)
        for p, old in zip(params, old_p):
            p.copy_(torch.where(ok, p, old))
        for p, old in zip(params, old_s):
            st = opt.state[p]
            for k, v in old.items():
                st[k] = torch.where(ok, st[k], v)
        opt.count = torch.where(ok, opt.count, old_count)
        if old_pending is not None:
            opt.pending_at = torch.where(ok, opt.pending_at, old_pending)
        self.bad_steps = self.bad_steps + (~ok).to(torch.int32)
        self.clock += 1


def skip_nonfinite(opt) -> SkipNonfinite:
    """Wrap ``opt`` in the §15 skip-step guard (``SkipNonfinite``);
    ``make_optimizer`` does so when ``cfg.skip_nonfinite``."""
    return SkipNonfinite(opt)


# ----------------------------------------------------------- refresh plane

def _inner(opt):
    """The optimizer under the skip-step guard, or ``opt`` itself."""
    return opt.opt if isinstance(opt, SkipNonfinite) else opt


def _params(opt) -> List[torch.Tensor]:
    return _inner(opt).param_groups[0]["params"]


def init_pending(opt) -> None:
    """Give an optimizer with a refresh plane its root refresh state:
    ``pending_at`` (the reference's root value: NO_PENDING, or the step
    the in-flight refresh was dispatched at), ``pending_host`` (what
    ``install_pending``/``discard_pending`` last wrote there, kept on the
    host when ``pending_at`` lives on the device) and ``pending_ready``
    (the CUDA event that marks the pending twins written, None when they
    were made on the caller's stream)."""
    opt.pending_at = opt.pending_host = NO_PENDING
    opt.pending_ready = None


def set_pending_at(opt, at: int, ready=None) -> None:
    """Write the root ``pending_at`` (a device int32 under the guard, no
    host-to-device copy) with its host mirror and ready event."""
    inner = _inner(opt)
    inner.pending_host = int(at)
    inner.pending_ready = ready
    if isinstance(inner.count, torch.Tensor):
        inner.pending_at = torch.full((), int(at), dtype=torch.int32,
                                      device=_params(inner)[0].device)
    else:
        inner.pending_at = int(at)


def install_pending(opt, partials, at_step: int, ready=None) -> None:
    """Merge a refresh result (one partial dict per parameter, in
    ``param_groups[0]["params"]`` order; empty or None leaves a slot as
    it is) into the state and stamp ``pending_at = at_step``: the step
    swaps pending -> active once ``count >= pending_at +
    precond_swap_delay``.  Reference swaps only: no device compute.
    ``ready`` is the event after which the twins are written (a refresh
    on a side stream), waited on by the step that swaps them in."""
    inner = _inner(opt)
    for p, part in zip(_params(inner), partials):
        if part:
            inner.state[p].update(part)
    set_pending_at(inner, at_step, ready)


def snapshot_overwritten_active(opt, partials):
    """Per-parameter snapshot of the ACTIVE (non-pending) keys a refresh
    result is about to overwrite (§15): the drift trackers ``rnorm`` and
    ``dnorm`` land at install, and a discarded refresh must leave no
    residue in the active plane (a NaN ``rnorm`` would disarm the drift
    trigger).  Reference capture only."""
    inner = _inner(opt)
    return [{k: inner.state[p][k] for k in part
             if k not in PENDING_STATE_KEYS and k in inner.state[p]}
            if part else None for p, part in zip(_params(inner), partials)]


def discard_pending(opt) -> None:
    """Mark any in-flight pending preconditioner stale (§12): a state
    restored mid-interval must never swap in a buffer whose payload the
    checkpoint dropped.  No-op for optimizers without a refresh plane."""
    if hasattr(_inner(opt), "pending_at"):
        set_pending_at(opt, NO_PENDING)


def wait_pending(opt) -> None:
    """Order the caller's stream after the in-flight refresh (a device-side
    wait, no host synchronization); no-op when none ran on a side
    stream."""
    ready = getattr(_inner(opt), "pending_ready", None)
    if ready is not None:
        torch.cuda.current_stream(_params(opt)[0].device).wait_event(ready)


def swap_pending(opt, pairs) -> None:
    """The §12 swap inside an async step.  ``pairs``: (state dict, active
    key) of every double-buffered entry; each key's pending twin is
    ``key + "_p"``.  Once ``count >= pending_at + precond_swap_delay``
    the twins become active and ``pending_at`` clears.  A host ``count``
    decides on the host, with no synchronization; a device ``count``
    (the guard's) decides on the device with ``torch.where``, from the
    step the guard's host clock (``host_count``, never below ``count``)
    allows on.  Only a step that may swap reads the twins, and it first
    waits for the refresh that wrote them (``wait_pending``)."""
    inner = _inner(opt)
    if inner.pending_host == NO_PENDING:
        return
    delay = inner.cfg.precond_swap_delay
    count = inner.count
    guarded = isinstance(count, torch.Tensor)
    if (inner.host_count if guarded else count) < inner.pending_host + delay:
        return
    wait_pending(inner)
    if not guarded:
        for st, k in pairs:
            st[k] = st[k + "_p"]
        inner.pending_at = inner.pending_host = NO_PENDING
        return
    at = inner.pending_at
    do = (at > NO_PENDING) & (count >= at + delay)
    for st, k in pairs:
        st[k] = torch.where(do, st[k + "_p"], st[k])
    inner.pending_at = torch.where(do, torch.full_like(at, NO_PENDING), at)


def merge_partials(*results):
    """One partial dict per parameter from several refresh results."""
    return [dict(kv for part in parts if part for kv in part.items())
            for parts in zip(*results)]


def precond_drift(opt) -> torch.Tensor:
    """Relative drift of the cached preconditioners since the last refresh
    dispatch (§12): the maximum over parameters of ``dnorm / max(rnorm,
    1e-12)``, a device scalar (0 without drift tracking)."""
    inner = _inner(opt)
    ds = [st["dnorm"] / torch.clamp(st["rnorm"], min=1e-12)
          for st in (inner.state[p] for p in _params(inner))
          if "dnorm" in st]
    if not ds:
        return torch.zeros((), dtype=torch.float32,
                           device=_params(inner)[0].device)
    return torch.max(torch.stack(ds))


def _partials_finite(partials) -> torch.Tensor:
    """0-d bool on the device: every float entry of a refresh result is
    finite.  A few reductions enqueued with the refresh (§15), read once,
    at swap time."""
    checks = [torch.isfinite(t).all() for part in partials if part
              for t in part.values() if t.is_floating_point()]
    if not checks:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(checks).all()


class AsyncPrecondService:
    """Host-side scheduler of the double-buffered refresh plane (§12;
    counterpart of the reference's ``base.AsyncPrecondService``).

    Decides WHEN to dispatch a refresh (the drift trigger, with the fixed
    clock as ceiling), dispatches the optimizer's ``pending_twins(key)``
    without blocking, installs them (``install_pending``) and keeps the
    ``matfn_telemetry`` counters.  Validated install (§15): every
    dispatch also enqueues ``_partials_finite`` over the twins; the
    verdict is read just before the swap would fire, and a non-finite
    buffer is discarded (never swapped) and re-dispatched with capped
    exponential backoff (1, 2, 4, ... steps, capped at the refresh
    period); after ``precond_max_retries`` consecutive failures the slot
    degrades (the last good active buffer keeps serving) until the next
    clock or drift trigger.

    On the card the twins are computed on a side CUDA stream: it first
    waits for everything the step's stream has queued (so it reads the
    finished ``mom`` or ``L``/``R``), every input it reads is recorded
    on it (the next step replaces those tensors, and their blocks must
    not return to the step stream's pool while the refresh reads them),
    its outputs are recorded on the step's stream (they are freed there
    once swapped in and replaced), and the verdict is copied into pinned
    host memory before an event closes the refresh.  The drift trackers
    ``rnorm``/``dnorm`` that the install resets are computed on the
    step's stream (``drift_baseline``), so that only the step that swaps
    waits for the refresh (``swap_pending``), and the host waits only
    for the verdict, at swap time (``ready.synchronize()``).  Given CPU
    parameters, everything runs in order on the CPU.
    """

    def __init__(self, opt, cfg=None):
        inner = _inner(opt)
        if not hasattr(inner, "pending_twins") or \
                not hasattr(inner, "pending_at"):
            raise ValueError("the optimizer has no refresh plane: Muon or "
                             "Shampoo with precond_async=True has one")
        self.opt = opt
        self.cfg = cfg = inner.cfg if cfg is None else cfg
        self.period = resolve_refresh_period(cfg)
        self.swap_delay = int(cfg.precond_swap_delay)
        self.threshold = cfg.drift_threshold
        self.max_retries = int(cfg.precond_max_retries)
        self._refresh = inner.pending_twins
        self._pending_check = None  # (verdict, ready event or None)
        self._overwritten = None  # active-key snapshot for a clean discard
        self._retry_at: Optional[int] = None
        self._side = None  # the side stream, made at the first dispatch
        self._verdict = None  # its pinned host flag
        self.failures = 0  # consecutive validation failures
        self.last_dispatch: Optional[int] = None
        self.last_drift: float = 0.0
        self.counters = {"refreshes": 0, "drift_triggered": 0,
                         "clock_triggered": 0, "bootstrap": 0,
                         "discarded": 0, "retries": 0, "degraded": 0}

    def due(self, step: int, drift: float) -> Optional[str]:
        """None, or why a refresh should dispatch at ``step``."""
        if self.last_dispatch is None:
            return "bootstrap"
        if step <= self.last_dispatch + self.swap_delay:
            # the previous refresh's swap has not run yet: dispatching now
            # would overwrite a never-consumed pending buffer
            return None
        if self._retry_at is not None and step >= self._retry_at:
            return "retries"  # backoff re-dispatch after a discard
        if step - self.last_dispatch >= self.period:
            return "clock_triggered"  # the fixed-schedule ceiling
        if self.threshold is not None and drift >= self.threshold:
            return "drift_triggered"
        return None

    def _check_pending(self, step: int, force: bool = False) -> None:
        """Read the in-flight verdict once the swap is about to fire;
        discard and schedule a backoff retry on failure."""
        if self._pending_check is None or self.last_dispatch is None:
            return
        if not force and step < self.last_dispatch + self.swap_delay:
            return  # the swap is not due yet: keep the check in flight
        verdict, ready = self._pending_check
        self._pending_check = None
        if ready is not None:
            ready.synchronize()  # the one host wait: the verdict's copy
        if bool(verdict):
            self.failures = 0
            self._retry_at = None
            self._overwritten = None
            return
        # a poisoned twin: never swap it in, and roll back the active
        # keys (drift trackers) its install overwrote
        if self._overwritten is not None:
            install_pending(self.opt, self._overwritten, NO_PENDING)
            self._overwritten = None
        discard_pending(self.opt)
        self.counters["discarded"] += 1
        self.failures += 1
        if self.failures >= self.max_retries:
            # degrade: keep serving the last good active buffer; only the
            # next clock/drift trigger tries again
            self.counters["degraded"] += 1
            self._retry_at = None
        else:
            self._retry_at = step + min(2 ** (self.failures - 1),
                                        self.period)

    def _verdict_of(self, twins) -> torch.Tensor:
        """The refresh's finiteness verdict, a 0-d device bool: over this
        rank's twins, and on a sharded model (the optimizer's ``blocks``)
        the AND over the world, so that every rank swaps or discards
        alike."""
        return _inner(self.opt).blocks.world_all(_partials_finite(twins))

    def _dispatch(self, key):
        """(pending twins, (verdict, ready event)): the refresh and its
        finiteness check, on the side stream on the card."""
        inner = _inner(self.opt)
        dev = _params(inner)[0].device
        if dev.type != "cuda":
            with torch.no_grad():
                twins = self._refresh(key)
                return twins, (self._verdict_of(twins), None)
        main = torch.cuda.current_stream(dev)
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
            self._verdict = torch.empty((), dtype=torch.bool,
                                        pin_memory=True)
        side = self._side
        side.wait_stream(main)
        for t in inner.refresh_inputs():
            t.record_stream(side)
        with torch.cuda.stream(side), torch.no_grad():
            twins = self._refresh(key)
            self._verdict.copy_(self._verdict_of(twins), non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        for part in twins:
            for t in (part or {}).values():
                t.record_stream(main)
        return twins, (self._verdict, ready)

    def step_begin(self, step: int, key, drift: float = 0.0) -> None:
        """Phase 1 of the two-phase step loop: validate an in-flight
        refresh whose swap is due, then maybe dispatch one.  Nothing here
        waits on the device except the verdict at swap time.  The
        bootstrap dispatch back-dates ``pending_at`` so that its swap
        fires on this very step, and reads its verdict at once."""
        self.last_drift = drift
        self._check_pending(step)
        reason = self.due(step, drift)
        if reason is None:
            return
        twins, check = self._dispatch(key)
        partials = merge_partials(twins, _inner(self.opt).drift_baseline())
        at = step - self.swap_delay if reason == "bootstrap" else step
        self._overwritten = snapshot_overwritten_active(self.opt, partials)
        install_pending(self.opt, partials, at, ready=check[1])
        self._pending_check = check
        self.last_dispatch = step
        self._retry_at = None
        self.counters["refreshes"] += 1
        self.counters[reason] += 1
        if reason == "bootstrap":
            self._check_pending(step, force=True)

    @property
    def matfn_telemetry(self) -> dict:
        return dict(self.counters, last_drift=self.last_drift)


def is_matrix_param(path_axes: tuple, shape: tuple,
                    allow_embed: bool = False) -> bool:
    """Muon applies to hidden weight matrices: >=2D, both matrix dims
    reasonably large, and not an embedding/vocab/codebook table
    (``allow_embed`` lifts the table exclusion)."""
    if not allow_embed and any(a in ("vocab", "codebooks")
                               for a in path_axes if a):
        return False
    dims = matrix_view_dims(path_axes, shape)
    if dims is None:
        return False
    m, n = dims
    return min(m, n) >= 16


def matrix_view_dims(path_axes: tuple, shape: tuple) -> Optional[tuple]:
    """(rows, cols) of the Muon matrix view; None if not matrix-like.

    The 'embed' logical axis marks the contraction side: the matrix is
    (embed-dim) x (product of remaining non-batch dims).  Leading 'layers'
    / 'experts' axes are batch.  Without an 'embed' tag, the last two dims
    form the matrix (generic case).
    """
    axes = tuple(path_axes)
    batch = {"layers", "experts"}
    non_batch = [(i, a) for i, a in enumerate(axes) if a not in batch]
    if len(non_batch) < 2:
        return None
    idxs = [i for i, _ in non_batch]
    names = [a for _, a in non_batch]
    if "embed" in names:
        e = idxs[names.index("embed")]
        m = shape[e]
        n = 1
        for i in idxs:
            if i != e:
                n *= shape[i]
        return (m, n)
    m = shape[idxs[-2]]
    n = shape[idxs[-1]]
    for i in idxs[:-2]:
        m *= shape[i]
    return (m, n)


def to_matrix_view(p: torch.Tensor, path_axes: tuple):
    """Reshape p to [..batch.., m, n] with 'embed' as the row dim (possibly
    transposed into place).  Returns (view, meta); inverse via
    ``from_matrix_view``."""
    axes = tuple(path_axes)
    batch = {"layers", "experts"}
    batch_idx = [i for i, a in enumerate(axes) if a in batch]
    other_idx = [i for i, a in enumerate(axes) if a not in batch]
    names = [axes[i] for i in other_idx]
    lead = tuple(p.shape[i] for i in batch_idx)
    if "embed" in names:
        e = other_idx[names.index("embed")]
        rest = [i for i in other_idx if i != e]
        perm = batch_idx + [e] + rest
        q = p.permute(perm)
        n = 1
        for i in rest:
            n *= p.shape[i]
        return q.reshape(lead + (p.shape[e], n)), (perm, tuple(q.shape))
    rest = tuple(p.shape[i] for i in other_idx)
    perm = batch_idx + other_idx
    q = p.permute(perm)
    mm = 1
    for d in rest[:-1]:
        mm *= d
    return q.reshape(lead + (mm, rest[-1])), (perm, tuple(q.shape))


def from_matrix_view(q: torch.Tensor, meta) -> torch.Tensor:
    perm, mid_shape = meta
    q = q.reshape(mid_shape)
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return q.permute(inv)
