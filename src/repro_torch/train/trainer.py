"""Fault-tolerant training loop (counterpart of ``repro/train/trainer.py``).

  * checkpoint/restart: crc-verified checkpoints every
    ``checkpoint_every`` steps (optionally through a background writer,
    joined before the next write and at the end); on start the run
    resumes from the newest checkpoint that verifies, with the model's
    parameters, the optimizer's state, its ``count`` (and the guard's
    ``bad_steps``) and the step restored;
  * deterministic stateless data: ``batch_fn(step)`` is pure, so a resumed
    run replays the same token stream, and the sketch key of step t is
    the root key folded with t whatever step the run started at
    (``train_step(batch, t, refresh)``);
  * the staleness schedule: with a refresh period K > 1 step t refreshes
    the preconditioners when t % K == 0 and serves them from the state
    otherwise (``refresh`` passed to the optimizer as a Python bool);
  * the §12 async refresh plane (``precond_async``): a two-phase step.
    ``self.precond`` (``base.AsyncPrecondService``) first maybe
    dispatches a refresh with the key ``Key(1).fold_in(t)`` (on a side
    CUDA stream on the card), fed the drift of the step before, read
    with its loss; then the step runs with ``refresh=False`` and
    launches no matrix function.  A restore marks the plane stale
    (``fault.discard_inflight``), and the new service bootstraps;
  * straggler detection: each step's wall time against the running
    median of the steps before it (the run's first step excluded), and a
    HEARTBEAT file ``"<step> <time>"`` written every step for external
    watchdogs.

The checkpoint tree is ``{"params": {name: tensor}, "opt": {name:
{state key: tensor}, "count": ..., ["pending_at": ...,] ["bad_steps":
...]}}``, flattened by ``checkpoint`` with the reference's ``|``
separator; the pending twins are left out.

Data parallelism (``mesh``, ``launch/mesh.py``, inside a world joined
with ``init_world``): the parameters and the optimizer state are
replicated, and every rank builds the global batch of step t from the
same stream and takes its own rows [r·B/s, (r+1)·B/s) (the reference's
``P(("pod", "data"), None)``); the train step averages the gradients
over the data group (``train/state.py``) and the optimizer shards its
matrix functions over the buckets' slices (DESIGN.md §8), under the
mesh's activation-sharding context, which also covers the §12 service's
refresh and its all-gather on the side stream.  Every host decision
(the refresh schedule, the drift trigger, the swap, the guard's verdict)
is taken from values bitwise equal on every rank, so every rank issues
the same collectives in the same order.  Only rank 0 of the world writes
checkpoints and the HEARTBEAT, and every rank waits at a barrier until
the write is done; a restore reads the whole state on a world of any
size (elastic).

The model axis (``shardings`` naming split parameters, the layout
``launch/sharding.py::tree_shardings(param_rules(cfg, mesh, strategy))``
gives, with ``strategy`` "tp" or "zero"): the Trainer shards the model
(``Model.shard``) and the optimizer keeps its moments as blocks; each
rank takes the rows of the strategy's batch axes ((pod, data) under
"tp", the whole mesh under "zero"), in row-major order over them.  A
checkpoint gathers every sharded leaf whole before rank 0 writes it (a
collective step), and a restore takes each rank's block under the
current layout, so a checkpoint written on one mesh and strategy resumes
on another.  Muon and Shampoo keep their cached preconditioners (and
the §12 twins) as ``precond_cache_sharding`` blocks, gathered whole into
a checkpoint like every other split leaf; under ``precond_async`` every
host decision of the refresh plane (the drift, the verdict) is taken
from values equal on every rank.  The moe family routes the global
batch across the ranks (``models/moe.py``: every rank builds one
process's slot table) and, under "tp", runs its experts by expert or
per-expert tensor parallelism; the vlm, audio, ssm and hybrid families
run their own layers on the model axis (``models/transformer.py``).
Pipeline stages raise (ROADMAP.md Queue 1 item 11c).
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch import collectives, sharding_ctx
from repro_torch.config import OptimizerConfig, TrainConfig
from repro_torch.core.rng import Key
from repro_torch.data import DataConfig, make_batch_fn
from repro_torch.launch import sharding
from repro_torch.models.transformer import Model
from repro_torch.optim import base, make_optimizer
from repro_torch.train import fault
from repro_torch.train.state import batch_group, make_train_step


class Trainer:
    """Train ``model`` with the optimizer ``ocfg`` names, on the synthetic
    stream ``dcfg`` (or on ``batch_fn(step)`` when given: the global
    batch), on the model's device; with a ``mesh``, as one rank of the
    world.  ``shardings`` ({"params": {name: Sharding}, ...}) names the
    parameters' layout under ``strategy`` ("tp" or "zero"): replicated
    on the data axis, or split (module docstring)."""

    def __init__(self, model: Model, ocfg: OptimizerConfig,
                 tcfg: TrainConfig, dcfg: DataConfig, mesh=None,
                 shardings=None, batch_fn: Optional[Callable] = None,
                 strategy: str = "tp"):
        if tcfg.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline stages (1F1B) are ported with ROADMAP.md Queue 1 "
                "item 11c")
        if shardings is not None and mesh is None:
            raise ValueError("shardings need a mesh")
        self.mesh = mesh
        self.group, self.n_data, self.row_index = None, 1, 0
        if mesh is not None:
            params = (shardings or {}).get("params", {})
            if model.layout is None and any(
                    sharding.sharded_axes(sh) for sh in params.values()):
                model.shard(mesh, params, strategy)
            self.group, self.n_data = batch_group(model, mesh)
            if self.group is not None:
                self.row_index = collectives.rank(self.group)
        self.rank = collectives.rank(None) if mesh is not None and \
            mesh.device_mesh is not None else 0
        self.model = model
        self.ocfg, self.tcfg, self.dcfg = ocfg, tcfg, dcfg
        self.device = next(model.parameters()).device
        full = batch_fn or make_batch_fn(model.cfg, dcfg, self.device)
        self.batch_fn = full if self.group is None else \
            self._own_rows(full)
        self._new_optimizer()
        self._ckpt_thread = None
        self.step_times: list = []
        self.straggler_events = 0

    def _own_rows(self, full: Callable) -> Callable:
        """``full``'s global batch cut to this rank's rows."""
        B = self.dcfg.global_batch
        if B % self.n_data:
            raise ValueError(f"global batch {B} does not divide over "
                             f"{self.n_data} data ranks")
        lo = self.row_index * (B // self.n_data)
        hi = lo + B // self.n_data
        return lambda t: {k: v[lo:hi] for k, v in full(t).items()}

    def _new_optimizer(self) -> None:
        lay = self.model.layout
        self.opt = make_optimizer(self.ocfg, self.model.named_parameters(),
                                  self.model.logical_axes(),
                                  None if lay is None else lay.shardings)
        self.step_fn = make_train_step(self.model, self.opt, self.ocfg,
                                       mesh=self.mesh)
        self.precond = (base.AsyncPrecondService(self.opt)
                        if self.ocfg.precond_async else None)

    @property
    def matfn_telemetry(self) -> Dict:
        """Refresh and drift counters of the async service ({} without
        one)."""
        return {} if self.precond is None else self.precond.matfn_telemetry

    # ------------------------------------------------------------- state

    def state_tree(self) -> Dict:
        """The checkpoint tree of the current state (live tensors)."""
        named = dict(self.model.named_parameters())
        opt = {k: dict(self.opt.state[p]) for k, p in named.items()}
        for k in ("count", "pending_at"):
            if hasattr(self.opt, k):
                v = getattr(self.opt, k)
                opt[k] = v if isinstance(v, torch.Tensor) else np.int32(v)
        if isinstance(self.opt, base.SkipNonfinite):
            opt["bad_steps"] = self.opt.bad_steps
        return {"params": named, "opt": opt}

    def state_shardings(self) -> Optional[Dict]:
        """The layout of ``state_tree()`` on a sharded model ({"params":
        ..., "opt": ...}, None otherwise): the optimizer's own
        (``base.Blocks.layouts``: the moments split like their parameter,
        the cached preconditioners and their twins as their
        ``precond_cache_sharding`` blocks, everything else whole)."""
        lay = self.model.layout
        if lay is None:
            return None
        layouts = self.opt.blocks.layouts
        opt = {k: {sk: layouts[i].get(sk) for sk in self.opt.state[p]}
               for i, (k, p) in enumerate(self.model.named_parameters())}
        return {"params": dict(lay.shardings), "opt": opt}

    def gathered_state_tree(self) -> Dict:
        """``state_tree()`` with every sharded leaf gathered whole
        (collective on a sharded model: every rank calls it)."""
        tree = self.state_tree()
        shards = self.state_shardings()
        if shards is None:
            return tree
        flat = ckpt_lib._flatten(tree)
        layout = ckpt_lib._flatten(shards)
        return ckpt_lib._unflatten({
            k: sharding.gather_full(v, layout.get(k), kind="checkpoint")
            if sharding.sharded_axes(layout.get(k)) else v
            for k, v in flat.items()})

    @torch.no_grad()
    def load_state_tree(self, tree: Dict) -> None:
        """Install a tree shaped like ``state_tree()``'s."""
        self.model.load_params(tree["params"])
        named = dict(self.model.named_parameters())
        for k, p in named.items():
            self.opt.state[p].update(tree["opt"][k])
        self.opt.count = int(tree["opt"]["count"])
        if "pending_at" in tree["opt"]:
            base.set_pending_at(self.opt, int(tree["opt"]["pending_at"]))
        if isinstance(self.opt, base.SkipNonfinite):
            self.opt.bad_steps = tree["opt"]["bad_steps"]

    def init_state(self, seed: Optional[int] = None) -> int:
        """A fresh optimizer over the model's parameters, drawn anew from
        ``seed`` when one is given (kept as they are otherwise); returns
        the start step, 0."""
        if seed is not None:
            self.model.reinit(seed)
        self._new_optimizer()
        return 0

    def restore_or_init(self, seed: Optional[int] = None) -> int:
        """Resume from the newest checkpoint that verifies, else
        ``init_state``; returns the step to run next."""
        cdir = self.tcfg.checkpoint_dir
        if cdir is None or ckpt.latest_step(cdir) is None:
            return self.init_state(seed)
        self.init_state(seed)
        # the file holds every leaf whole, whatever world, mesh and
        # strategy wrote it: each rank takes its block of the current
        # layout (every leaf whole on replicated parameters)
        step, tree = ckpt.restore(cdir, self.state_tree(),
                                  allow_missing=base.PENDING_STATE_KEYS,
                                  shardings=self.state_shardings())
        self.load_state_tree(tree)
        # a resumed run never swaps in a buffer it did not dispatch
        fault.discard_inflight(self.opt)
        self._log(f"[trainer] resumed from step {step}")
        return step

    def _sharded(self):
        """The mesh's activation-sharding context (none without one)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        lay = self.model.layout
        return sharding_ctx.activation_sharding(
            self.mesh, sharding.activation_rules(
                self.model.cfg, self.mesh,
                "tp" if lay is None else lay.strategy))

    def _log(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def _checkpoint(self, step: int) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()  # one in-flight write at a time
            self._ckpt_thread = None
        tree = self.gathered_state_tree()
        if self.rank == 0:
            self._ckpt_thread = ckpt.save(
                self.tcfg.checkpoint_dir, step, tree,
                keep=self.tcfg.keep_checkpoints,
                async_write=self.tcfg.async_checkpoint,
                drop=base.PENDING_STATE_KEYS)
        if self.mesh is not None and self.mesh.device_mesh is not None:
            # every rank goes on once rank 0's write is complete
            if self._ckpt_thread is not None:
                self._ckpt_thread.join()
                self._ckpt_thread = None
            collectives.barrier()

    # ------------------------------------------------------------- loop

    def run(self, steps: Optional[int] = None, seed: Optional[int] = None,
            on_metrics: Optional[Callable] = None):
        """Train up to step ``steps`` (``tcfg.steps``), resuming where a
        checkpoint left off; ``on_metrics(t, metrics)`` after every step.
        Returns (params, optimizer state, losses of the steps run)."""
        steps = steps or self.tcfg.steps
        start = self.restore_or_init(seed)
        cdir = self.tcfg.checkpoint_dir
        if cdir is not None:
            os.makedirs(cdir, exist_ok=True)
        K = base.resolve_refresh_period(self.ocfg)
        losses = []
        drift = 0.0
        for t in range(start, steps):
            t0 = time.perf_counter()
            if self.precond is not None:
                # the refresh's buckets shard over the mesh as in-step
                # ones do (its all-gathers run on the side stream)
                with self._sharded():
                    self.precond.step_begin(t, Key(1).fold_in(t),
                                            drift=drift)
                refresh = False
            else:
                refresh = (t % K == 0) if K > 1 else None
            metrics = self.step_fn(self.batch_fn(t), t, refresh)
            if self.precond is not None:
                # one read for both: the drift adds no synchronization
                loss, drift = torch.stack([metrics["loss"].float(),
                                           metrics["precond_drift"]]).tolist()
            else:
                loss = float(metrics["loss"])  # waits for the whole step
            dt = time.perf_counter() - t0
            if t > start:  # the first step of a run builds and warms up
                self.step_times.append(dt)
                med = statistics.median(self.step_times)
                if dt > self.tcfg.straggler_slack * med and \
                        len(self.step_times) > 5:
                    self.straggler_events += 1
                    self._log(f"[trainer] straggler: step {t} took "
                              f"{dt:.2f}s (median {med:.2f}s)")
            if cdir is not None and self.rank == 0:
                with open(os.path.join(cdir, "HEARTBEAT"), "w") as f:
                    f.write(f"{t} {time.time()}")
            losses.append(loss)
            if t % self.tcfg.log_every == 0:
                self._log(f"[trainer] step {t}: loss {loss:.4f} grad_norm "
                          f"{float(metrics['grad_norm']):.4f} "
                          f"({dt * 1e3:.1f} ms)")
            if on_metrics is not None:
                on_metrics(t, metrics)
            if cdir is not None and self.tcfg.checkpoint_every and \
                    (t + 1) % self.tcfg.checkpoint_every == 0:
                self._checkpoint(t + 1)
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        base.wait_pending(self.opt)  # the state returned may be read
        tree = self.state_tree()
        return tree["params"], tree["opt"], losses
