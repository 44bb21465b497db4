"""Shampoo and the §12 async refresh plane on sharded parameters, in a world
of 4 ranks on gloo on a (data 2, model 2) mesh (the port's counterpart of
tests/test_sharded_precond.py:170, sharded against replicated Shampoo,
and of tests/test_async_precond.py:375, double-buffered Muon on a mesh;
the gpt2-paper SMOKE config, fp32).

Every rank holds its block of every parameter under
``tree_shardings(param_rules(cfg, mesh, strategy))`` and its optimizer
keeps the moments as blocks and the cached preconditioners ("Linv",
"Rinv", "ortho" and their "_p" twins) as their ``precond_cache_sharding``
blocks.  The inputs are made from numpy seeds; every rank also runs the
same steps as one process of the port, its reference:

* Shampoo, PRISM-5 and the Fig. 5 fitted preset, under "tp" and "zero",
  two steps with ``precondition_every=2`` (a refresh, then a step that
  serves the cached roots): every leaf, gathered whole after each step,
  within 2e-5 of one process (the reference's sharded-vs-replicated
  bound), and each cache block within 2e-5 of its largest entry of one
  process's cache cut by the layout.  The fitted alphas are pinned: each
  rank replays one process's alphas for its share of a bucket's slices
  (a rank-deficient factor's alpha moves with the last bits of its
  traces in either package, ROADMAP.md Queue 3).
* One process's Shampoo steps on the world's gradients against the JAX
  package's ``make_optimizer(...).update`` (the bounds of
  tests/test_torch_shampoo.py::test_shampoo_update_matches_reference).
* Three Trainer steps of Shampoo under each strategy within 1e-4 of the
  JAX package's unsharded ``make_train_step`` on the same weights and
  batches (the bound of tests/test_torch_model_axis.py).
* Async Muon (under "tp", and under "zero" with ``muon_local_reshard`` on
  the grid tier) and async Shampoo (both strategies): ``precond_every``
  3, swap delay 1, 7 steps through ``base.AsyncPrecondService`` against
  one process at 2e-5; at least 3 refreshes, the same counters on every
  rank and the same drift on every rank at every step.
* A NaN planted in rank 1's pending block is discarded on every rank:
  the pending slot cleared, the active blocks bitwise unchanged,
  ``discarded`` 1.
* The §15 guard: a NaN in rank 1's block of the embedding's gradient
  (an elementwise AdamW leaf no other rank reads) rolls the step back on
  every rank.
* A checkpoint of an async Muon Trainer under "tp" holds every cache
  whole, restores under "zero" as blocks, bitwise, and trains on; one
  process restores it bitwise too.

Without a world: every cache of gpt2-paper and of every dense SMOKE
config on the (2, 2) mesh splits evenly or drops the axis.
"""
import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import build
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.state import make_train_step as jmake_train_step
from repro.train.state import master_params
from repro_torch import collectives, convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.config import OptimizerConfig, PrismConfig, TrainConfig
from repro_torch.configs import arch_ids, get_config, get_smoke_config
from repro_torch.core import prism
from repro_torch.core.rng import Key
from repro_torch.data import DataConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding
from repro_torch.models import Model
from repro_torch.models.transformer import param_specs
from repro_torch.optim import base, make_optimizer
from repro_torch.sharding_ctx import activation_sharding
from repro_torch.train import Trainer
from test_torch_shampoo import _hold, _jax_run, _ocfgs, _port_opt, _port_run
import torch_world
import torch_threads  # noqa: F401  (the worker's share of the cores)

WORLD = 4
TOL = 2e-5
JAX_TOL = 1e-4
ARCH = "gpt2-paper"
CFG32 = dict(dtype="float32", emb_dtype="float32")
STRATEGIES = ("tp", "zero")
GUARDED = ("muon", "adamw")  # Muon and its AdamW-branch leaf; AdamW alone
STEPS, BATCH, SEQ = 3, 8, 32
UPDATE_STEPS = 2
ASYNC_STEPS = 7
PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)
PENDING_AT = "opt|pending_at"  # a restore marks its refresh stale
CACHE_KEYS = ("ortho", "Linv", "Rinv", "ortho_p", "Linv_p", "Rinv_p")
#: the async runs: (optimizer, strategy, extra config)
ASYNC = {"muon/tp": ("muon", "tp", {}),
         "muon/zero": ("muon", "zero", dict(muon_local_reshard=True)),
         "shampoo/tp": ("shampoo", "tp", {}),
         "shampoo/zero": ("shampoo", "zero", {})}


def _smoke():
    return get_smoke_config(ARCH).replace(**CFG32)


def _inputs():
    """The JAX package's SMOKE weights (numpy), the Trainer's batches and
    ASYNC_STEPS sets of whole gradients, N(0, 0.01) entries."""
    init = jax.tree.map(np.asarray,
                        build(jsmoke(ARCH).replace(**CFG32)).init(
                            jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (BATCH, SEQ)).astype(np.int64)
               for _ in range(STEPS)]
    rng = np.random.default_rng(1)
    grads = [{k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
              for k, v in convert._flatten(init).items()}
             for _ in range(ASYNC_STEPS)]
    return init, batches, grads


def _axes():
    return {k: a for k, (_, a, _) in param_specs(_smoke()).items()}


def _shardings(mesh, strategy):
    cfg = _smoke()
    specs = param_specs(cfg)
    return sharding.tree_shardings(
        mesh, {k: a for k, (_, a, _) in specs.items()},
        sharding.param_rules(cfg, mesh, strategy),
        {k: s for k, (s, _, _) in specs.items()})


def _named(init, mesh=None, strategy="tp"):
    """(name, parameter) pairs of the SMOKE weights, each this rank's block
    under the strategy's layout on a mesh, with the layout (None
    without)."""
    whole = convert.params_from_jax(init, _smoke())
    if mesh is None:
        return [(k, torch.nn.Parameter(v.clone()))
                for k, v in whole.items()], None
    shards = _shardings(mesh, strategy)
    coords = mesh.coords()
    return [(k, torch.nn.Parameter(sharding.local_block(
        v, shards[k], coords).clone())) for k, v in whole.items()], shards


def _context(mesh, strategy):
    if mesh is None:
        return contextlib.nullcontext()
    return activation_sharding(mesh, sharding.activation_rules(
        _smoke(), mesh, strategy))


def _set_grads(named, shards, g, mesh):
    for k, p in named:
        t = torch.from_numpy(g[k])
        if shards is not None:
            t = sharding.local_block(t, shards[k], mesh.coords()).clone()
        p.grad = t


def _whole(named, shards):
    return {k: (p.detach() if shards is None else sharding.gather_full(
        p.detach(), shards[k])).numpy().copy() for k, p in named}


class Alphas:
    """Records the fitted alphas of a run in call order, or (``replay``)
    hands a one-process run's back: a rank whose §8 engine fits ``per``
    slices of a bucket takes the recorded alphas of its share, the
    ``index``-th ``per`` of the bucket (the engine's identity pad slices
    keep their own)."""

    def __init__(self, replay=None, index=0):
        self.alphas, self.replay, self.index = [], replay, index

    def __enter__(self):
        self._real = real = prism.fit_alpha_from_traces

        def fit(*a, **k):
            out = real(*a, **k)
            alpha = out[0] if isinstance(out, tuple) else out
            if self.replay is not None:
                want = torch.from_numpy(self.replay[len(self.alphas)])
                per = alpha.shape[0]
                piece = want[self.index * per:(self.index + 1) * per]
                alpha = torch.cat([piece.to(alpha), alpha[len(piece):]])
                out = (alpha,) + tuple(out[1:]) if isinstance(out, tuple) \
                    else alpha
            self.alphas.append(alpha.numpy().copy())
            return out

        prism.fit_alpha_from_traces = fit
        return self

    def __exit__(self, *exc):
        prism.fit_alpha_from_traces = self._real


def _caches(opt, named):
    return {f"{k}.{sk}": v.float().numpy().copy() for k, p in named
            for sk, v in opt.state[p].items() if sk in CACHE_KEYS}


def _shampoo_steps(which, init, grads, mesh=None, strategy="tp",
                   replay=None):
    """UPDATE_STEPS Shampoo steps of the preset ``which`` with
    ``precondition_every=2``; returns (whole parameters after each step,
    this rank's caches, the alphas, the caches' layouts, the collective
    kinds)."""
    named, shards = _named(init, mesh, strategy)
    _, ocfg = _ocfgs(which, precondition_every=2)
    opt = make_optimizer(ocfg, named, _axes(), shards)
    index = 0 if mesh is None else collectives.rank(mesh.group(("data",)))
    after = []
    with Alphas(replay, index) as tape, \
            collectives.count_collectives() as calls:
        for s in range(UPDATE_STEPS):
            _set_grads(named, shards, grads[s], mesh)
            with _context(mesh, strategy):
                opt.step(key=Key(0).fold_in(s))
            after.append(_whole(named, shards))
    layouts = {} if shards is None else {
        f"{k}.{sk}": sh for (k, _), lay in zip(named, opt.blocks.layouts)
        for sk, sh in lay.items() if sk in CACHE_KEYS}
    return (after, _caches(opt, named), tape.alphas, layouts,
            sorted({c.kind for c in calls}))


def _shampoo_update(which, strategy, init, grads, mesh):
    one, one_caches, alphas, _, _ = _shampoo_steps(which, init, grads)
    got, caches, _, layouts, kinds = _shampoo_steps(
        which, init, grads, mesh, strategy,
        replay=alphas if which == "fig5" else None)
    coords = mesh.coords()
    want = {k: np.ascontiguousarray(sharding.local_block(
        one_caches[k], sh, coords)) for k, sh in layouts.items()}
    return {"one": one, "got": got, "caches": caches, "want": want,
            "kinds": kinds, "fits": len(alphas),
            "whole": {k: v.shape for k, v in one_caches.items()}}


def _async_cfg(name, **kw):
    if name == "shampoo":
        return _ocfgs("warm", precond_every=3, precond_async=True,
                      precond_swap_delay=1, **kw)[1]
    return OptimizerConfig(
        name="muon", learning_rate=0.02, precond_every=3,
        precond_async=True, precond_swap_delay=1,
        prism=PrismConfig(fuse="off" if kw else "auto", **PRISM5), **kw)


def _async_steps(name, strategy, extra, init, grads, mesh=None, plant=None):
    """ASYNC_STEPS steps of the async plane (the reference test's loop):
    ``step_begin`` with the last step's drift, then a step that launches
    no matrix function.  ``plant(svc, t)`` runs before each
    ``step_begin``."""
    named, shards = _named(init, mesh, strategy)
    opt = make_optimizer(_async_cfg(name, **extra), named, _axes(), shards)
    svc = base.AsyncPrecondService(opt)
    drift, drifts = 0.0, []
    with collectives.count_collectives() as calls:
        for t in range(ASYNC_STEPS if plant is None else 5):
            if plant is not None:
                plant(svc, opt, named, t)
            with _context(mesh, strategy):
                svc.step_begin(t, Key(7).fold_in(t), drift=drift)
                _set_grads(named, shards, grads[t], mesh)
                opt.step(key=Key(0).fold_in(t), refresh=False)
            drift = float(base.precond_drift(opt))
            drifts.append(drift)
    return {"params": _whole(named, shards), "drifts": drifts,
            "counters": dict(svc.counters), "caches": _caches(opt, named),
            "kinds": sorted({c.kind for c in calls})}


def _nan_run(init, grads, mesh, rank):
    """Async Muon under "tp": the refresh dispatched at step 3 (the clock)
    writes a NaN into rank 1's pending block; its verdict, read at step
    4, must discard it on every rank."""
    seen = {}

    def plant(svc, opt, named, t):
        if t == 3:
            real = svc._refresh

            def poisoned(key):
                parts = real(key)
                if rank == 1:
                    part = next(p for p in parts if p and "ortho_p" in p)
                    part["ortho_p"].view(-1)[0] = float("nan")
                return parts
            svc._refresh = poisoned
        if t == 4:
            seen["pending_before"] = opt.pending_host
            seen["active"] = {k: opt.state[p]["ortho"].clone()
                              for k, p in named if "ortho" in opt.state[p]}
            real_begin = svc.step_begin

            def step_begin(*a, **k):
                real_begin(*a, **k)
                seen["pending_after"] = opt.pending_host
                seen["unchanged"] = all(
                    torch.equal(opt.state[p]["ortho"], seen["active"][k])
                    for k, p in named if "ortho" in opt.state[p])
                svc.step_begin = real_begin
            svc.step_begin = step_begin

    out = _async_steps("muon", "tp", {}, init, grads, mesh, plant)
    seen.pop("active")
    return dict(seen, counters=out["counters"],
                finite=bool(all(np.isfinite(v).all()
                                for v in out["params"].values())))


def _guard_run(init, grads, mesh, rank, name):
    """One step of optimizer ``name`` under the §15 guard on the mesh with
    a NaN in rank 1's block of the embedding's gradient (elementwise in
    both: no other rank sees it): every rank must roll the step back."""
    named, shards = _named(init, mesh, "tp")
    cfg = (_async_cfg("muon") if name == "muon"
           else OptimizerConfig(name="adamw", learning_rate=1e-3))
    opt = make_optimizer(dataclasses.replace(
        cfg, precond_async=False, skip_nonfinite=True),
        named, _axes(), shards)
    before = {k: p.detach().clone() for k, p in named}
    _set_grads(named, shards, grads[0], mesh)
    if rank == 1:
        dict(named)["embed"].grad.view(-1)[0] = float("nan")
    with _context(mesh, "tp"):
        opt.step(key=Key(0).fold_in(0))
    # the moments of a split parameter are named blocks like it
    split = [i for i, (k, _) in enumerate(named)
             if sharding.sharded_axes(shards[k])]
    like = all(opt.blocks.layouts[i]["mom"] is shards[named[i][0]]
               for i in split) and bool(split)
    return {"unchanged": all(torch.equal(p, before[k]) for k, p in named),
            "bad_steps": int(opt.bad_steps), "count": int(opt.count),
            "moments_like_params": like}


def _trainer(mesh, strategy, batches, ocfg, steps, ckpt_dir=None, every=0,
             init=None):
    model = Model(_smoke(), device="cpu")
    model.load_params(convert.params_from_jax(init, _smoke()))
    return Trainer(model, ocfg, TrainConfig(
        steps=steps, checkpoint_dir=ckpt_dir, checkpoint_every=every,
        async_checkpoint=False), DataConfig(
        vocab_size=model.cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
        mesh=mesh, shardings=None if mesh is None else {
            "params": _shardings(mesh, strategy)},
        strategy=strategy, batch_fn=lambda t: {
            "tokens": torch.from_numpy(batches[t % STEPS])})


def _state(tree):
    return {k: np.asarray(v.detach().float().numpy() if isinstance(
        v, torch.Tensor) else v).copy() for k, v in ck._flatten(tree).items()
        if not set(k.split("|")) & base.PENDING_STATE_KEYS}


def _async_checkpoint(init, batches, mesh, ckpt_dir):
    """4 steps of async Muon under "tp" with a checkpoint at step 4, then
    a Trainer under "zero" restores it (each cache as its block) and runs
    2 more steps."""
    ocfg = _async_cfg("muon")
    tr = _trainer(mesh, "tp", batches, ocfg, 4, ckpt_dir, 4, init)
    tr.run()
    saved = _state(tr.gathered_state_tree())
    tr2 = _trainer(mesh, "zero", batches, ocfg, 6, ckpt_dir, 0, init)
    start = tr2.restore_or_init()
    restored = _state(tr2.gathered_state_tree())
    coords = mesh.coords()
    layouts = tr2.state_shardings()["opt"]
    blocks = {}
    for k, p in tr2.model.named_parameters():
        for sk, v in tr2.opt.state[p].items():
            if sk in CACHE_KEYS and sk not in base.PENDING_STATE_KEYS:
                whole = torch.from_numpy(saved[f"opt|{k}|{sk}"])
                want = sharding.local_block(whole, layouts[k][sk], coords)
                blocks[f"{k}.{sk}"] = (tuple(v.shape), tuple(whole.shape),
                                       bool(torch.equal(v.float(), want)))
    _, _, losses = tr2.run()
    return {"saved": saved, "start": start, "restored": restored,
            "blocks": blocks, "losses": losses,
            "telemetry": tr2.matfn_telemetry}


def _ranks(rank, world, init, batches, grads, ckpt_dir, out_dir):
    mesh = tmesh.make_debug_mesh(data=2, model=2)
    res = {"coords": mesh.coords()}
    for which in ("warm", "fig5"):
        for strategy in STRATEGIES:
            res[f"shampoo/{which}/{strategy}"] = _shampoo_update(
                which, strategy, init, grads, mesh)
    for case, (name, strategy, extra) in ASYNC.items():
        res[f"async/{case}"] = (
            _async_steps(name, strategy, extra, init, grads),
            _async_steps(name, strategy, extra, init, grads, mesh))
    res["nan"] = _nan_run(init, grads, mesh, rank)
    for name in GUARDED:
        res[f"guard/{name}"] = _guard_run(init, grads, mesh, rank, name)
    for strategy in STRATEGIES:
        tr = _trainer(mesh, strategy, batches, _ocfgs("warm")[1], STEPS,
                      init=init)
        res[f"trainer/{strategy}"] = tr.run()[2]
    res["ckpt"] = _async_checkpoint(init, batches, mesh, ckpt_dir)
    torch_world.save(out_dir, rank, res)


def _jax_losses(init, batches):
    """The JAX package's unsharded Shampoo train step (PRISM-5) on the
    same weights and batches."""
    jm = build(jsmoke(ARCH).replace(**CFG32))
    ocfg = _ocfgs("warm")[0]
    opt = jmake_optimizer(ocfg, jm.logical_axes())
    p = master_params(jax.tree.map(jnp.asarray, init))
    s = opt.init(p)
    step = jax.jit(jmake_train_step(jm, opt, ocfg))
    losses = []
    for t, b in enumerate(batches):
        p, s, m = step(p, s, {"tokens": jnp.asarray(b, jnp.int32)}, t)
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("model_axis_precond")
    init, batches, grads = _inputs()
    ckpt_dir = str(out / "ckpt")
    ctx = torch_world.start_world(_ranks, WORLD, out, init, batches, grads,
                                  ckpt_dir, str(out))
    ref = _jax_losses(init, batches)
    torch_world.join_world(ctx)
    return (init, batches, grads, ckpt_dir, ref,
            [torch_world.load(out, r) for r in range(WORLD)])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("which", ["warm", "fig5"])
def test_shampoo_update_matches_one_process(world, which, strategy):
    """Every leaf, gathered whole after each of the two steps, within 2e-5
    of one process; each cache block within 2e-5 of its largest entry of
    one process's cache cut by its ``precond_cache_sharding``; the
    gradient gathered as kind "opt", the stale step's roots as kind
    "cache"."""
    ranks = world[5]
    for r in ranks:
        res = r[f"shampoo/{which}/{strategy}"]
        for t, (got, want) in enumerate(zip(res["got"], res["one"])):
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                           err_msg=f"step {t} {k}")
        assert set(res["caches"]) == set(res["want"])
        assert any(k.endswith("Linv") for k in res["caches"])
        for k, v in res["want"].items():
            assert res["caches"][k].shape == v.shape, k
            np.testing.assert_allclose(
                res["caches"][k], v, rtol=0,
                atol=TOL * max(1.0, float(np.abs(v).max())), err_msg=k)
        assert {"opt", "cache", "engine"} <= set(res["kinds"])
        assert (res["fits"] > 0) == (which == "fig5")


@pytest.mark.parametrize("which", ["warm", "fig5"])
def test_cache_bytes_are_the_layouts_blocks(world, which):
    """A rank's cache bytes are the blocks the layout gives: every SMOKE
    cache splits its 2 layers over model and its rows over data, so each
    rank holds a quarter of each whole cache, and the four ranks' blocks
    tile it."""
    ranks = world[5]
    for r in ranks:
        res = r[f"shampoo/{which}/tp"]
        for k, shape in res["whole"].items():
            sh = sharding.precond_cache_sharding(
                tmesh.make_debug_mesh(2, 2), shape)
            assert res["caches"][k].shape == sharding.local_shape(shape, sh)
            assert res["caches"][k].size * WORLD == np.prod(shape), k
        mine = sum(v.nbytes for v in res["caches"].values())
        assert mine * WORLD == sum(
            np.prod(s) * 4 for s in res["whole"].values())


def test_one_process_shampoo_matches_the_reference(world):
    """One process of the port's Shampoo (PRISM-5, ``precondition_every``
    2) on the world's first two gradient sets against the JAX package's
    ``make_optimizer(...).update``."""
    init, _, grads = world[0], world[1], world[2]
    jcfg, tcfg = _ocfgs("warm", precondition_every=2)
    jm = build(jsmoke(ARCH))
    jp, js = _jax_run(jcfg, jm, init, grads[:UPDATE_STEPS])
    named, topt = _port_opt(tcfg, init)
    _port_run(named, topt, grads[:UPDATE_STEPS])
    _hold(named, topt, jp, js, "warm", init)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_shampoo_trainer_matches_the_reference(world, strategy):
    """Three Trainer steps of Shampoo on the world within 1e-4 of the JAX
    package's unsharded step; every rank the same losses."""
    ref, ranks = world[4], world[5]
    for r in ranks:
        np.testing.assert_allclose(r[f"trainer/{strategy}"], ref,
                                   rtol=JAX_TOL, atol=JAX_TOL)
        assert r[f"trainer/{strategy}"] == ranks[0][f"trainer/{strategy}"]


@pytest.mark.parametrize("case", list(ASYNC))
def test_async_plane_matches_one_process(world, case):
    """Seven async steps on the mesh within 2e-5 of one process; at least
    3 refreshes and the same counters on every rank; the drift each rank
    read identical on every rank at every step (and near one process's);
    no collective of the refresh path missing."""
    ranks = world[5]
    name = ASYNC[case][0]
    for r in ranks:
        one, got = r[f"async/{case}"]
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=TOL,
                                       atol=TOL, err_msg=k)
        assert got["counters"]["refreshes"] >= 3, got["counters"]
        assert got["counters"] == one["counters"]
        assert got["counters"] == ranks[0][f"async/{case}"][1]["counters"]
        assert got["drifts"] == ranks[0][f"async/{case}"][1]["drifts"]
        np.testing.assert_allclose(got["drifts"], one["drifts"], rtol=1e-5)
        assert {"opt" if name == "muon" else "engine", "cache",
                "verdict"} <= set(got["kinds"])
        if name == "muon":
            assert "drift" in got["kinds"]
        if case == "muon/zero":
            assert "gram" in got["kinds"]  # the local reshard's refresh


def test_nan_in_one_ranks_pending_block_is_discarded_everywhere(world):
    ranks = world[5]
    for r in ranks:
        nan = r["nan"]
        assert nan["pending_before"] == 3
        assert nan["pending_after"] == base.NO_PENDING
        assert nan["unchanged"]
        assert nan["counters"]["discarded"] == 1, nan["counters"]
        assert nan["finite"]
        assert nan["counters"] == ranks[0]["nan"]["counters"]


@pytest.mark.parametrize("name", GUARDED)
def test_guard_rolls_back_on_every_rank(world, name):
    """The §15 guard's verdict is the world's: a NaN in one rank's block
    of an elementwise leaf's gradient rolls the step back everywhere."""
    for r in world[5]:
        assert r[f"guard/{name}"] == {"unchanged": True, "bad_steps": 1,
                                      "count": 0, "moments_like_params":
                                      True}, r[f"guard/{name}"]


def test_async_checkpoint_restores_as_blocks_under_the_other_strategy(
        world):
    """The checkpoint holds every cache whole; a Trainer under "zero"
    restores every leaf bitwise and each cache as its block of the
    layout, marks the refresh in flight at the checkpoint stale
    (``pending_at``), and trains on with the async plane
    bootstrapping."""
    _, _, _, ckpt_dir, _, ranks = world
    data = np.load(os.path.join(ckpt_dir, "step_00000004", "tree.npz"))
    for r in ranks:
        c = r["ckpt"]
        assert c["start"] == 4
        assert set(c["restored"]) == set(c["saved"])
        assert c["saved"][PENDING_AT] == 3  # dispatched at step 3
        assert c["restored"][PENDING_AT] == base.NO_PENDING
        for k, v in c["saved"].items():
            if k != PENDING_AT:
                np.testing.assert_array_equal(c["restored"][k], v, err_msg=k)
        assert c["blocks"], "no cached preconditioner restored"
        for k, (block, whole, equal) in c["blocks"].items():
            assert equal, k
            assert np.prod(block) * WORLD == np.prod(whole), (k, block)
        assert all(np.isfinite(c["losses"]))
        assert c["telemetry"]["bootstrap"] == 1
        assert c["losses"] == ranks[0]["ckpt"]["losses"]
    whole = {k: v.shape for k, v in ranks[0]["ckpt"]["saved"].items()}
    caches = [k for k in data.files if k.rsplit("|", 1)[-1] in CACHE_KEYS]
    assert caches
    for k in caches:
        assert data[k].shape == whole[k], k


def test_one_process_restores_the_async_world_checkpoint(world):
    init, batches, _, ckpt_dir, _, ranks = world
    tr = _trainer(None, "tp", batches, _async_cfg("muon"), 4, ckpt_dir, 0,
                  init)
    assert tr.restore_or_init() == 4
    got = _state(tr.state_tree())
    want = ranks[0]["ckpt"]["saved"]
    assert set(got) == set(want)
    assert got[PENDING_AT] == base.NO_PENDING
    for k, v in got.items():
        if k != PENDING_AT:
            np.testing.assert_array_equal(v, want[k], err_msg=k)


# ------------------------------------------------------------ no world

def _cache_shapes(cfg):
    """Muon's "ortho" views and Shampoo's inverse-root shapes of ``cfg``
    (default ``max_precond_dim``)."""
    maxd = OptimizerConfig(name="shampoo").max_precond_dim
    out = []
    for shape, axes, _ in param_specs(cfg).values():
        if not base.is_matrix_param(axes, tuple(shape), allow_embed=True):
            continue
        view = tuple(base.to_matrix_view(torch.empty(shape, device="meta"),
                                         axes)[0].shape)
        out.append(view)
        out += [view[:-2] + (k, k) for k in view[-2:] if k <= maxd]
    return out


@pytest.mark.parametrize("arch", ["gpt2-paper-full"] + [
    a for a in arch_ids() if get_config(a).family == "dense"])
def test_every_cache_splits_or_drops_the_axis(arch):
    mesh = tmesh.make_debug_mesh(2, 2)
    cfg = get_config("gpt2-paper") if arch == "gpt2-paper-full" \
        else get_smoke_config(arch)
    shapes = _cache_shapes(cfg)
    assert shapes
    for shape in shapes:
        sh = sharding.precond_cache_sharding(mesh, shape)
        local = sharding.local_shape(shape, sh)
        assert sharding.full_shape(local, sh) == shape
        for dim, entry in enumerate(sh.spec):
            axis = "data" if dim == len(shape) - 2 else \
                "model" if dim == 0 else None
            if axis is not None:
                assert (entry == axis) == (shape[dim] % 2 == 0), \
                    (shape, sh.spec)
