"""The moe family on a mesh, in a world of 4 ranks on gloo on a (data 2,
model 2) mesh (the widths of tests/test_torch_model_axis.py: the SMOKE
configs, seq 32, global batch 8, fp32 compute).

granite-moe-smoke (8 experts, ``sharding="expert"``: under "tp" each
model rank owns 4 experts) and mixtral-smoke (4 experts,
``sharding="tensor"``: under "tp" each model rank holds every expert's
half of ``expert_mlp``), under "tp" and "zero", with ``dispatch``
"global" (one slot table over the global batch, built alike on every
rank from the experts chosen by every row, gathered in row order) and
"per_sample":

* the loss, the aux loss and every leaf's reduced gradient, gathered
  whole, against one process of the port on the global batch at 2e-5
  (a rank-local dispatch, a per-rank aux, or a missing or doubled model
  SUM of the router's gradient shows here), and the loss against the
  JAX package's unsharded ``model.loss`` on the same weights at 1e-4;
* a drop case at ``capacity_factor`` 0.5: assignments are dropped, as
  many as one process drops, and the world still matches one process;
* three Muon steps of the Trainer under "tp" within 1e-4 of the JAX
  package's unsharded ``make_train_step``, with a checkpoint that a
  Trainer resumes under "zero" (Muon's local reshard on the grid tier):
  every restored leaf, gathered, equals the checkpoint bitwise, and its
  losses lie within 1e-4 of one process resuming it;
* Shampoo under "zero", async Muon under "tp" and a data mesh (4, 1) with
  replicated parameters, each a few Trainer steps against one process at
  2e-5.

Without a world: ``launch/train.py --mesh production`` builds granite's
and mixtral's layouts (tests/test_torch_model_axis.py), and the vlm,
audio, ssm and hybrid families' Trainers on a model axis ask for a
process group (tests/test_torch_family_mesh.py trains them in one).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.configs import get_smoke_config as jsmoke
from repro.models import build
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.state import make_train_step as jmake_train_step
from repro.train.state import master_params
from repro_torch import collectives, convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.config import OptimizerConfig, PrismConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding
from repro_torch.models import Model, moe
from repro_torch.models.transformer import param_specs
from repro_torch.sharding_ctx import activation_sharding
from repro_torch.train import Trainer
from repro_torch.train.state import reduce_sharded, reduction_axes
import torch_world
import torch_threads  # noqa: F401  (the worker's share of the cores)

WORLD = 4
TOL = 2e-5
JAX_TOL = 1e-4
STEPS, RESUME_STEPS, BATCH, SEQ = 3, 2, 8, 32
GRANITE, MIXTRAL = "granite-moe-1b-a400m", "mixtral-8x7b"
ARCHS = (GRANITE, MIXTRAL)
STRATEGIES = ("tp", "zero")
DISPATCHES = ("global", "per_sample")
DROP_CAPACITY = 0.5
CFG32 = dict(dtype="float32", emb_dtype="float32")
PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8)
#: name -> (arch, strategy, dispatch, capacity_factor or None)
GRAD_CASES = {f"{a}/{s}/{d}": (a, s, d, None)
              for a in ARCHS for s in STRATEGIES for d in DISPATCHES}
GRAD_CASES.update({f"{a}/tp/global/drop": (a, "tp", "global", DROP_CAPACITY)
                   for a in ARCHS})
#: the resume: the grid tier (the SMOKE buckets would take the fused
#: tier), Muon's local reshard
RESUME_PRISM, RESUME = dict(fuse="off"), dict(muon_local_reshard=True)
#: Trainer runs against one process: name -> (arch, mesh, strategy,
#: steps, optimizer config)
RUNS = {"shampoo/zero": (MIXTRAL, (2, 2), "zero", 2,
                         dict(name="shampoo")),
        "async/tp": (GRANITE, (2, 2), "tp", 3,
                     dict(precond_every=2, precond_async=True)),
        "data/replicated": (GRANITE, (4, 1), None, 2, {})}


def _cfg(arch, dispatch="global", capacity=None):
    cfg = get_smoke_config(arch).replace(**CFG32)
    kw = {"dispatch": dispatch}
    if capacity is not None:
        kw["capacity_factor"] = capacity
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _inputs():
    """Each arch's SMOKE weights (the port draws them; numpy) and the
    batches."""
    inits = {a: {k: p.detach().numpy().copy() for k, p in
                 Model(_cfg(a), device="cpu", seed=0).named_parameters()}
             for a in ARCHS}
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (BATCH, SEQ)).astype(np.int64)
               for _ in range(STEPS)]
    return inits, batches


def _model(init, cfg):
    model = Model(cfg, device="cpu")
    model.load_params({k: torch.from_numpy(v) for k, v in init.items()})
    return model


def _shardings(cfg, mesh, strategy):
    specs = param_specs(cfg)
    return sharding.tree_shardings(
        mesh, {k: a for k, (_, a, _) in specs.items()},
        sharding.param_rules(cfg, mesh, strategy),
        {k: s for k, (s, _, _) in specs.items()})


def _ocfg(prism_kw=(), **kw):
    return OptimizerConfig(**{"name": "muon", "learning_rate": 0.02, **kw},
                           prism=PrismConfig(use_kernels=True,
                                             **dict(prism_kw), **PRISM5))


def _np(t):
    return t.detach().float().numpy().copy()


def _dropped(drops):
    return sum(int(d) for _, d in drops)


def _grads(case, init, batch, mesh):
    """(loss, aux, {name: gathered reduced gradient}, collective kinds,
    dropped assignments) of one forward and backward on this rank's
    rows."""
    arch, strategy, dispatch, cap = GRAD_CASES[case]
    cfg = _cfg(arch, dispatch, cap)
    model = _model(init, cfg)
    model.shard(mesh, _shardings(cfg, mesh, strategy), strategy)
    lay = model.layout
    group = mesh.group(lay.batch_axes)
    per = BATCH // lay.batch_size
    lo = collectives.rank(group) * per
    names = [k for k, _ in model.named_parameters()]
    with collectives.count_collectives() as calls, \
            moe.count_drops() as drops, activation_sharding(
                mesh, sharding.activation_rules(cfg, mesh, strategy)):
        loss, metrics = model.loss({"tokens": torch.from_numpy(
            batch[lo:lo + per])})
        loss.backward()
    grads = reduce_sharded([p.grad for p in model.parameters()], lay,
                           reduction_axes(lay, names))
    whole = {k: _np(sharding.gather_full(g, lay.shardings[k]))
             for k, g in zip(names, grads)}
    mean = collectives.all_reduce(loss.detach().clone(), "sum", group)
    return (float(mean) / lay.batch_size, float(metrics["aux"].detach()),
            whole,
            sorted({c.kind for c in calls}), _dropped(drops))


def _state(tree):
    return {k: np.asarray(v.detach().float().numpy() if isinstance(
        v, torch.Tensor) else v).copy() for k, v in ck._flatten(tree).items()}


def _trainer(init, batches, cfg, ocfg, mesh=None, strategy="tp",
             ckpt_dir=None, steps=STEPS, every=0):
    return Trainer(_model(init, cfg), ocfg, TrainConfig(
        steps=steps, checkpoint_dir=ckpt_dir, checkpoint_every=every,
        async_checkpoint=False), DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
        mesh=mesh, shardings=None if mesh is None or strategy is None
        else {"params": _shardings(cfg, mesh, strategy)},
        strategy=strategy or "tp", batch_fn=lambda t: {
            "tokens": torch.from_numpy(batches[t % STEPS])})


def _elastic(init, batches, mesh, ckpt_dir):
    """STEPS Muon steps of granite under "tp" with a checkpoint at the
    last; then a Trainer resumes it under "zero" with the local
    reshard."""
    cfg = _cfg(GRANITE)
    tr = _trainer(init, batches, cfg, _ocfg(), mesh, "tp", ckpt_dir, STEPS,
                  STEPS)
    _, _, l1 = tr.run()
    saved = _state(tr.gathered_state_tree())
    tr2 = _trainer(init, batches, cfg, _ocfg(RESUME_PRISM, **RESUME), mesh,
                   "zero", ckpt_dir, STEPS + RESUME_STEPS)
    start = tr2.restore_or_init()
    restored = _state(tr2.gathered_state_tree())
    with collectives.count_collectives() as calls:
        _, _, l2 = tr2.run()
    return {"l1": l1, "saved": saved, "start": start, "restored": restored,
            "l2": l2, "grams": sum(c.kind == "gram" for c in calls)}


def _run(name, inits, batches, mesh=None):
    """The losses of RUNS[name], on ``mesh`` (its shape's) or one
    process."""
    arch, shape, strategy, steps, okw = RUNS[name]
    if mesh is not None and tuple(mesh.shape.values()) != shape:
        mesh = tmesh.make_debug_mesh(*shape)
    _, _, losses = _trainer(inits[arch], batches, _cfg(arch), _ocfg(**okw),
                            mesh, strategy if mesh is not None else None,
                            steps=steps).run()
    return losses


def _ranks(rank, world, inits, batches, ckpt_dir, out_dir):
    mesh = tmesh.make_debug_mesh(data=2, model=2)
    res = {case: _grads(case, inits[GRAD_CASES[case][0]], batches[0], mesh)
           for case in GRAD_CASES}
    res["elastic"] = _elastic(inits[GRANITE], batches, mesh, ckpt_dir)
    res.update({name: _run(name, inits, batches, mesh) for name in RUNS})
    torch_world.save(out_dir, rank, res)


def _jax_losses(inits, batches):
    """The JAX package's loss of every gradient case's config on batch 0,
    and the losses of its unsharded train step for STEPS Muon steps of
    granite."""
    out, seen = {}, {}
    tb = {"tokens": jnp.asarray(batches[0], jnp.int32)}
    for case, (arch, _, dispatch, cap) in GRAD_CASES.items():
        key = (arch, dispatch, cap)
        if key not in seen:
            jcfg = jsmoke(arch).replace(**CFG32)
            kw = {"dispatch": dispatch}
            if cap is not None:
                kw["capacity_factor"] = cap
            jm = build(jcfg.replace(moe=dataclasses.replace(jcfg.moe, **kw)))
            params = jax.tree.map(jnp.asarray,
                                  convert.params_to_jax(_torch(inits[arch])))
            seen[key] = float(jax.jit(jm.loss)(params, tb)[0])
        out[case] = seen[key]
    jm = build(jsmoke(GRANITE).replace(**CFG32))
    ocfg = JOpt(name="muon", learning_rate=0.02, prism=JPrism(**PRISM5))
    opt = jmake_optimizer(ocfg, jm.logical_axes())
    p = master_params(jax.tree.map(
        jnp.asarray, convert.params_to_jax(_torch(inits[GRANITE]))))
    s = opt.init(p)
    step = jax.jit(jmake_train_step(jm, opt, ocfg))
    losses = []
    for t, b in enumerate(batches):
        p, s, m = step(p, s, {"tokens": jnp.asarray(b, jnp.int32)}, t)
        losses.append(float(m["loss"]))
    out["train"] = losses
    return out


def _torch(init):
    return {k: torch.from_numpy(v) for k, v in init.items()}


def _one_process(inits, batches):
    out = {}
    for case, (arch, _, dispatch, cap) in GRAD_CASES.items():
        model = _model(inits[arch], _cfg(arch, dispatch, cap))
        with moe.count_drops() as drops:
            loss, metrics = model.loss({"tokens": torch.from_numpy(
                batches[0])})
        loss.backward()
        out[case] = (float(loss.detach()), float(metrics["aux"].detach()),
                     {k: _np(p.grad) for k, p in model.named_parameters()},
                     _dropped(drops))
    out.update({name: _run(name, inits, batches) for name in RUNS})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_mesh")
    inits, batches = _inputs()
    ckpt_dir = str(out / "ckpt")
    ctx = torch_world.start_world(_ranks, WORLD, out, inits, batches,
                                  ckpt_dir, str(out))
    ref = _jax_losses(inits, batches)
    one = _one_process(inits, batches)
    torch_world.join_world(ctx)
    return (inits, batches, ckpt_dir, ref, one,
            [torch_world.load(out, r) for r in range(WORLD)])


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_aux_and_gradients_match_one_process(world, case):
    one, ranks = world[4], world[5]
    want_loss, want_aux, want, want_drops = one[case]
    _, strategy, dispatch, cap = GRAD_CASES[case]
    for r in ranks:
        loss, aux, grads, kinds, drops = r[case]
        np.testing.assert_allclose(loss, want_loss, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(aux, want_aux, rtol=TOL, atol=TOL)
        assert set(grads) == set(want)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        # the routing statistics cross the batch group; the tokens' slot
        # table too under global dispatch, never under per_sample
        assert "moe" in kinds
        assert ("tp" in kinds) == (strategy == "tp")
        if dispatch == "global":
            # every rank built the global batch's slot table: one
            # process's drops
            assert drops == want_drops
    if cap is not None:
        assert want_drops > 0


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_matches_the_reference(world, case):
    ref, ranks = world[3], world[5]
    for r in ranks:
        np.testing.assert_allclose(r[case][0], ref[case], rtol=JAX_TOL,
                                   atol=JAX_TOL)


def test_trainer_tp_then_elastic_zero(world):
    """Three Muon steps under "tp" against the JAX package's unsharded
    step; the resume under "zero" restores every leaf bitwise and lies
    within 1e-4 of one process resuming the same checkpoint."""
    inits, batches, ckpt_dir, ref, _, ranks = world
    for r in ranks:
        e = r["elastic"]
        np.testing.assert_allclose(e["l1"], ref["train"], rtol=JAX_TOL,
                                   atol=JAX_TOL)
        assert e["start"] == STEPS
        assert set(e["restored"]) == set(e["saved"])
        for k, v in e["saved"].items():
            np.testing.assert_array_equal(e["restored"][k], v, err_msg=k)
        assert e["grams"] > 0  # the local reshard ran its Gram all-reduce
        assert e["l2"] == ranks[0]["elastic"]["l2"]
    one = _trainer(inits[GRANITE], batches, _cfg(GRANITE),
                   _ocfg(RESUME_PRISM, **RESUME), ckpt_dir=ckpt_dir,
                   steps=STEPS + RESUME_STEPS)
    _, _, losses = one.run()
    assert len(losses) == RESUME_STEPS
    np.testing.assert_allclose(ranks[0]["elastic"]["l2"], losses,
                               rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_runs_match_one_process(world, name):
    one, ranks = world[4], world[5]
    for r in ranks:
        assert len(r[name]) == RUNS[name][3]
        np.testing.assert_allclose(r[name], one[name], rtol=TOL, atol=TOL)


# ------------------------------------------------------------ no world

def test_other_families_refuse_a_model_axis():
    """vlm, audio, ssm and hybrid on a model axis are taken now (they
    raised item 11h before): outside a world their Trainers need the
    process group, as the dense and moe families' do
    (tests/test_torch_family_mesh.py trains them in one)."""
    mesh = tmesh.make_debug_mesh(data=1, model=2)
    dcfg = DataConfig(vocab_size=256, seq_len=SEQ, global_batch=BATCH)
    for arch in ("llava-next-34b", "musicgen-medium", "falcon-mamba-7b",
                 "recurrentgemma-2b"):
        model = Model(get_smoke_config(arch), device="cpu")
        with pytest.raises(RuntimeError, match="no process group"):
            Trainer(model, _ocfg(), TrainConfig(), dcfg, mesh=mesh,
                    shardings={"params": _shardings(model.cfg, mesh, "tp")})
