"""The vlm, audio, ssm and hybrid families on a mesh, in a world of 4 ranks
on gloo on a (data 2, model 2) mesh (the widths of
tests/test_torch_moe_mesh.py: the SMOKE configs, seq 32, global batch 8,
fp32 compute).

falcon-mamba-smoke (under "tp" each model rank runs 64 of the 128
``d_inner`` channels: ``in_proj`` gathered over the model axis, ``x_proj``'s
partial sum summed forward and backward), recurrentgemma-smoke (one
(rec, rec, attn) period and two tail layers: each rank 32 of the 64 LRU
channels, the gates reduce-scattered onto them, 8 of the 16 padded heads,
the single kv head replicated), musicgen-medium-smoke (4 codebooks, each
table and head split over the model axis on its vocab dim) and
llava-next-34b-smoke (16 patches a row, ``vision_proj`` gathered on use),
under "tp" and "zero":

* the loss and every leaf's reduced gradient, gathered whole, against one
  process of the port on the global batch at 2e-5 (a gradient that lacks
  or doubles a sum over the model axis shows here), and the loss against
  the JAX package's unsharded ``model.loss`` on the same weights at 1e-4;
* for ssm and hybrid, two Muon steps of the Trainer under "tp" within
  1e-4 of the JAX package's unsharded ``make_train_step``, with a
  checkpoint that a Trainer resumes under "zero": every restored leaf,
  gathered, equals the checkpoint bitwise, and its step lies within 1e-4
  of one process resuming it.
"""
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
from repro_torch.models import Model
from repro_torch.models.transformer import param_specs
from repro_torch.sharding_ctx import activation_sharding
from repro_torch.train import Trainer
from repro_torch.train.state import reduce_sharded, reduction_axes
import torch_world
import torch_threads  # noqa: F401  (the worker's share of the cores)

WORLD = 4
TOL = 2e-5
JAX_TOL = 1e-4
STEPS, BATCH, SEQ = 2, 8, 32
FALCON, RGEMMA = "falcon-mamba-7b", "recurrentgemma-2b"
MUSICGEN, LLAVA = "musicgen-medium", "llava-next-34b"
ARCHS = (FALCON, RGEMMA, MUSICGEN, LLAVA)
TRAINED = (FALCON, RGEMMA)
STRATEGIES = ("tp", "zero")
CFG32 = dict(dtype="float32", emb_dtype="float32")
PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8)
#: the collective kinds each family's layers issue under "tp" (besides
#: the "tp" of the embedding, the attention, the mlps and the CE)
TP_KINDS = {FALCON: {"tp_gather", "tp_sum"}, RGEMMA: {"tp_scatter"},
            MUSICGEN: set(), LLAVA: set()}
GRAD_CASES = {f"{a}/{s}": (a, s) for a in ARCHS for s in STRATEGIES}


def _cfg(arch):
    return get_smoke_config(arch).replace(**CFG32)


def _batch(cfg, rng):
    shape = (BATCH, cfg.num_codebooks, SEQ) if cfg.family == "audio" \
        else (BATCH, SEQ)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int64)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return out


def _inputs():
    """Each arch's SMOKE weights (the port draws them; numpy) and STEPS
    global batches of each."""
    inits = {a: {k: p.detach().numpy().copy() for k, p in
                 Model(_cfg(a), device="cpu", seed=0).named_parameters()}
             for a in ARCHS}
    rng = np.random.default_rng(0)
    batches = {a: [_batch(_cfg(a), rng) for _ in range(STEPS)]
               for a in ARCHS}
    return inits, batches


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _model(init, cfg):
    model = Model(cfg, device="cpu")
    model.load_params(_torch(init))
    return model


def _shardings(cfg, mesh, strategy):
    specs = param_specs(cfg)
    return sharding.tree_shardings(
        mesh, {k: a for k, (_, a, _) in specs.items()},
        sharding.param_rules(cfg, mesh, strategy),
        {k: s for k, (s, _, _) in specs.items()})


def _ocfg():
    return OptimizerConfig(name="muon", learning_rate=0.02,
                           prism=PrismConfig(use_kernels=True, **PRISM5))


def _np(t):
    return t.detach().float().numpy().copy()


def _grads(case, init, batch, mesh):
    """(loss, {name: gathered reduced gradient}, collective kinds) of one
    forward and backward on this rank's rows."""
    arch, strategy = GRAD_CASES[case]
    cfg = _cfg(arch)
    model = _model(init, cfg)
    model.shard(mesh, _shardings(cfg, mesh, strategy), strategy)
    lay = model.layout
    group = mesh.group(lay.batch_axes)
    per = BATCH // lay.batch_size
    lo = collectives.rank(group) * per
    names = [k for k, _ in model.named_parameters()]
    with collectives.count_collectives() as calls, activation_sharding(
            mesh, sharding.activation_rules(cfg, mesh, strategy)):
        loss, _ = model.loss({k: torch.from_numpy(v[lo:lo + per])
                              for k, v in batch.items()})
        loss.backward()
    grads = reduce_sharded([p.grad for p in model.parameters()], lay,
                           reduction_axes(lay, names))
    whole = {k: _np(sharding.gather_full(g, lay.shardings[k]))
             for k, g in zip(names, grads)}
    mean = collectives.all_reduce(loss.detach().clone(), "sum", group)
    return (float(mean) / lay.batch_size, whole,
            sorted({c.kind for c in calls}))


def _state(tree):
    return {k: np.asarray(v.detach().float().numpy() if isinstance(
        v, torch.Tensor) else v).copy() for k, v in ck._flatten(tree).items()}


def _trainer(arch, init, batches, mesh=None, strategy="tp", ckpt_dir=None,
             steps=STEPS, every=0):
    cfg = _cfg(arch)
    return Trainer(_model(init, cfg), _ocfg(), TrainConfig(
        steps=steps, checkpoint_dir=ckpt_dir, checkpoint_every=every,
        async_checkpoint=False), DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
        mesh=mesh, shardings=None if mesh is None
        else {"params": _shardings(cfg, mesh, strategy)},
        strategy=strategy, batch_fn=lambda t: _torch(batches[t % STEPS]))


def _elastic(arch, init, batches, mesh, ckpt_dir):
    """STEPS Muon steps under "tp" with a checkpoint at the last; then a
    Trainer resumes it under "zero" for one step."""
    tr = _trainer(arch, init, batches, mesh, "tp", ckpt_dir, STEPS, STEPS)
    _, _, l1 = tr.run()
    saved = _state(tr.gathered_state_tree())
    tr2 = _trainer(arch, init, batches, mesh, "zero", ckpt_dir, STEPS + 1)
    start = tr2.restore_or_init()
    restored = _state(tr2.gathered_state_tree())
    _, _, l2 = tr2.run()
    return {"l1": l1, "saved": saved, "start": start, "restored": restored,
            "l2": l2}


def _ranks(rank, world, inits, batches, ckpt_dir, out_dir):
    mesh = tmesh.make_debug_mesh(data=2, model=2)
    res = {case: _grads(case, inits[GRAD_CASES[case][0]],
                        batches[GRAD_CASES[case][0]][0], mesh)
           for case in GRAD_CASES}
    for arch in TRAINED:
        res[f"{arch}/elastic"] = _elastic(arch, inits[arch], batches[arch],
                                          mesh, f"{ckpt_dir}/{arch}")
    torch_world.save(out_dir, rank, res)


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in b.items()}


def _jax_reference(inits, batches):
    """The JAX package's loss of each arch on its batch 0, and the losses
    of its unsharded train step for STEPS Muon steps of each trained
    arch."""
    out = {}
    for arch in ARCHS:
        jm = build(jsmoke(arch).replace(**CFG32))
        params = jax.tree.map(jnp.asarray,
                              convert.params_to_jax(_torch(inits[arch])))
        out[arch] = float(jax.jit(jm.loss)(params,
                                           _jax_batch(batches[arch][0]))[0])
        if arch not in TRAINED:
            continue
        ocfg = JOpt(name="muon", learning_rate=0.02, prism=JPrism(**PRISM5))
        opt = jmake_optimizer(ocfg, jm.logical_axes())
        p = master_params(params)
        s = opt.init(p)
        step = jax.jit(jmake_train_step(jm, opt, ocfg))
        losses = []
        for t, b in enumerate(batches[arch]):
            p, s, m = step(p, s, _jax_batch(b), t)
            losses.append(float(m["loss"]))
        out[f"{arch}/train"] = losses
    return out


def _one_process(inits, batches):
    out = {}
    for arch in ARCHS:
        model = _model(inits[arch], _cfg(arch))
        loss, _ = model.loss(_torch(batches[arch][0]))
        loss.backward()
        out[arch] = (float(loss.detach()),
                     {k: _np(p.grad) for k, p in model.named_parameters()})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("family_mesh")
    inits, batches = _inputs()
    ckpt_dir = str(out / "ckpt")
    ctx = torch_world.start_world(_ranks, WORLD, out, inits, batches,
                                  ckpt_dir, str(out))
    ref = _jax_reference(inits, batches)
    one = _one_process(inits, batches)
    torch_world.join_world(ctx)
    return (inits, batches, ckpt_dir, ref, one,
            [torch_world.load(out, r) for r in range(WORLD)])


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_and_gradients_match_one_process(world, case):
    one, ranks = world[4], world[5]
    arch, strategy = GRAD_CASES[case]
    want_loss, want = one[arch]
    for r in ranks:
        loss, grads, kinds = r[case]
        np.testing.assert_allclose(loss, want_loss, rtol=TOL, atol=TOL)
        assert set(grads) == set(want)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        new = {"tp_gather", "tp_sum", "tp_scatter"}
        if strategy == "tp":
            assert "tp" in kinds
            assert new & set(kinds) == TP_KINDS[arch]
        else:
            assert not ({"tp"} | new) & set(kinds)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_matches_the_reference(world, case):
    ref, ranks = world[3], world[5]
    arch = GRAD_CASES[case][0]
    for r in ranks:
        np.testing.assert_allclose(r[case][0], ref[arch], rtol=JAX_TOL,
                                   atol=JAX_TOL)


@pytest.mark.parametrize("arch", TRAINED)
def test_trainer_tp_then_elastic_zero(world, arch):
    """STEPS Muon steps under "tp" against the JAX package's unsharded
    step; the resume under "zero" restores every leaf bitwise and its
    step lies within 1e-4 of one process resuming the same checkpoint."""
    inits, batches, ckpt_dir, ref, _, ranks = world
    for r in ranks:
        e = r[f"{arch}/elastic"]
        np.testing.assert_allclose(e["l1"], ref[f"{arch}/train"],
                                   rtol=JAX_TOL, atol=JAX_TOL)
        assert e["start"] == STEPS
        assert set(e["restored"]) == set(e["saved"])
        for k, v in e["saved"].items():
            np.testing.assert_array_equal(e["restored"][k], v, err_msg=k)
        assert e["l2"] == ranks[0][f"{arch}/elastic"]["l2"]
    one = _trainer(arch, inits[arch], batches[arch],
                   ckpt_dir=f"{ckpt_dir}/{arch}", steps=STEPS + 1)
    _, _, losses = one.run()
    assert len(losses) == 1
    np.testing.assert_allclose(ranks[0][f"{arch}/elastic"]["l2"], losses,
                               rtol=JAX_TOL, atol=JAX_TOL)


# ------------------------------------------------------------ no world


def test_production_layout_of_every_family():
    """``launch/train.py --mesh production`` lays out the four families
    without a world: each vocab table, codebook table and head over the
    model axis on its vocab dim (no pad: 65,024, 256,000 and 2,048 rows
    divide by 16), Mamba's ``d_inner`` and the RG-LRU width over it, the
    hybrid's heads and mlp columns, the replicated kv heads."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    want = {
        FALCON: {"embed": (("model", "data"), (4064, 256)),
                 "head": (("data", "model"), (256, 4064)),
                 "layers.mamba.in_proj": ((None, "data", "model"),
                                          (64, 256, 1024)),
                 "layers.mamba.x_proj": ((None, "model", None),
                                         (64, 512, 288)),
                 "layers.mamba.A_log": ((None, "model", None),
                                        (64, 512, 16)),
                 "layers.mamba.dt_proj": ((None, None, "model"),
                                          (64, 256, 512))},
        RGEMMA: {"embed": (("model", "data"), (16000, 160)),
                 "layers.p0.rglru.in_x": ((None, "data", "model"),
                                          (8, 160, 160)),
                 "layers.p0.rglru.w_a": ((None, "model", None),
                                         (8, 160, 2560)),
                 "layers.p2.attn.wq": ((None, "data", "model", None),
                                       (8, 160, 1, 256)),
                 "layers.p2.attn.wk": ((None, "data", None, None),
                                       (8, 160, 1, 256)),
                 "layers.p0.mlp.w_up": ((None, "data", "model"),
                                        (8, 160, 480)),
                 "tail.0.rglru.in_x": (("data", "model"), (160, 160))},
        MUSICGEN: {"embed": ((None, "model", "data"), (4, 128, 96)),
                   "heads": ((None, "data", "model"), (4, 96, 128))},
        LLAVA: {"embed": (("model", "data"), (4000, 448)),
                "vision_proj": ((None, "data"), (1152, 448))},
    }
    for arch, leaves in want.items():
        cfg = get_config(arch)
        mesh, shards = train.production_layout(cfg)
        assert mesh.shape == {"data": 16, "model": 16}
        p = shards["params"]
        specs = param_specs(cfg)
        for k, (spec, local) in leaves.items():
            assert p[k].spec == spec, (arch, k)
            assert sharding.local_shape(specs[k][0], p[k]) == local
        for k, (shape, _, _) in specs.items():
            local = sharding.local_shape(shape, p[k])
            assert sharding.full_shape(local, p[k]) == tuple(shape)
