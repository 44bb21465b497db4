"""The model axis for training in a world of 4 ranks on gloo, on a (data 2,
model 2) mesh (counterpart of tests/test_sharded_train.py, its widths: the
SMOKE configs, seq 32, global batch 8).

Each rank keeps its block of every parameter under
``tree_shardings(param_rules(cfg, mesh, strategy))`` (``Model.shard``) and
computes on it: under "tp" FSDP over data and tensor parallelism over
model (2 rows a data rank), under "zero" every leaf flat-sharded over
(data, model) (2 rows a rank).  For the qwen3-14b SMOKE config (GQA,
qk_norm, SwiGLU) and the gpt2-paper SMOKE config (MHA, qkv bias, gelu),
in fp32, the loss and every leaf's reduced gradient, gathered whole, match
one process of the port at 2e-5 (a missing or doubled model-axis SUM
shows here), and the loss matches the JAX package's ``model.loss`` on the
same converted weights at 1e-4.

The Trainer's elastic run (the reference's test at these widths, with
the launcher's PRISM-5, whose alphas are static, so no sketch key enters;
the resume pins the grid tier, the local reshard's):
3 steps of "tp" at fp32 write a checkpoint, whose losses lie within 1e-4
of the JAX package's unsharded ``make_train_step`` on the same weights and
batches; a new Trainer resumes it under "zero" with
``muon_local_reshard`` and bf16 gradients (a bf16 model): every restored
leaf, gathered, equals the checkpoint bitwise, its last loss lies below
the first run's first (the reference's assertion), and its losses lie
within 5e-3 (BF16_LOSS_TOL of tests/test_torch_sharded_train.py) of one
process resuming the same checkpoint; one process restores the world's
checkpoint bitwise.

Shape-only cases need no world: every leaf of the ten configs splits into
blocks that cover it exactly on the (2, 2), (1, 4), (16, 16) and (2, 16,
16) meshes, and ``launch/train.py --mesh production`` builds gpt2-paper's
and qwen3-14b's layouts without a world and refuses a world of the wrong
size, and builds granite-moe-1b-a400m's (expert parallelism) and
mixtral-8x7b's (each expert's columns) layouts.
"""
import socket

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
from repro_torch.configs import arch_ids, get_config, get_smoke_config
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
BF16_LOSS_TOL = 5e-3
STEPS, BATCH, SEQ = 3, 8, 32
ARCHS = ("qwen3-14b", "gpt2-paper")
STRATEGIES = ("tp", "zero")
PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8)
CFG32 = dict(dtype="float32", emb_dtype="float32")
ELASTIC = "qwen3-14b"
#: the resume's optimizer: the grid tier (the SMOKE shapes would take the
#: fused tier, which keeps the batch engine), the local reshard, bf16
#: gradients
RESUME = dict(fuse="off", grads_dtype="bfloat16", muon_local_reshard=True)
MESHES = {"2x2": ((2, 2), False), "1x4": ((1, 4), False),
          "16x16": ((16, 16), False), "2x16x16": ((16, 16), True)}


def _inputs():
    inits = {}
    for arch in ARCHS:
        cfg = jsmoke(arch).replace(**CFG32)
        inits[arch] = jax.tree.map(np.asarray,
                                   build(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (BATCH, SEQ)).astype(np.int64)
               for _ in range(STEPS)]
    return inits, batches


def _model(arch, init, **cfg_kw):
    cfg = get_smoke_config(arch).replace(**cfg_kw)
    model = Model(cfg, device="cpu")
    model.load_params(convert.params_from_jax(init, cfg))
    return model


def _shardings(model, mesh, strategy):
    specs = param_specs(model.cfg)
    return sharding.tree_shardings(
        mesh, {k: a for k, (_, a, _) in specs.items()},
        sharding.param_rules(model.cfg, mesh, strategy),
        {k: s for k, (s, _, _) in specs.items()})


def _ocfg(fuse="auto", **kw):
    return OptimizerConfig(name="muon", learning_rate=0.02,
                           prism=PrismConfig(use_kernels=True, fuse=fuse,
                                             **PRISM5), **kw)


def _np(t):
    return t.detach().float().numpy().copy()


def _grads(arch, strategy, init, batch, mesh):
    """(loss, {name: gathered reduced gradient}, collective kinds) of one
    forward and backward on this rank's rows."""
    model = _model(arch, init, **CFG32)
    model.shard(mesh, _shardings(model, mesh, strategy), strategy)
    lay = model.layout
    group = mesh.group(lay.batch_axes)
    per = BATCH // lay.batch_size
    lo = collectives.rank(group) * per
    names = [k for k, _ in model.named_parameters()]
    with collectives.count_collectives() as calls, activation_sharding(
            mesh, sharding.activation_rules(model.cfg, mesh, strategy)):
        loss, _ = model.loss({"tokens": torch.from_numpy(
            batch[lo:lo + per])})
        loss.backward()
    grads = reduce_sharded([p.grad for p in model.parameters()], lay,
                           reduction_axes(lay, names))
    whole = {k: _np(sharding.gather_full(g, lay.shardings[k]))
             for k, g in zip(names, grads)}
    mean = collectives.all_reduce(loss.detach().clone(), "sum", group)
    kinds = sorted({c.kind for c in calls})
    return float(mean) / lay.batch_size, whole, kinds


def _state(tree):
    return {k: np.asarray(v.detach().float().numpy() if isinstance(
        v, torch.Tensor) else v).copy() for k, v in ck._flatten(tree).items()}


def _trainer(model, mesh, strategy, batches, ckpt_dir, steps, every, **okw):
    return Trainer(model, _ocfg(**okw), TrainConfig(
        steps=steps, checkpoint_dir=ckpt_dir, checkpoint_every=every,
        async_checkpoint=False), DataConfig(
        vocab_size=model.cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
        mesh=mesh, shardings=None if mesh is None else {
            "params": _shardings(model, mesh, strategy)},
        strategy=strategy, batch_fn=lambda t: {
            "tokens": torch.from_numpy(batches[t % STEPS])})


def _elastic(init, batches, mesh, ckpt_dir):
    """3 steps of "tp" at fp32 with a checkpoint at the last; then a
    resume under "zero" with the local reshard and bf16 gradients."""
    tr = _trainer(_model(ELASTIC, init, **CFG32), mesh, "tp", batches,
                  ckpt_dir, STEPS, STEPS)
    _, _, l1 = tr.run()
    saved = _state(tr.gathered_state_tree())
    tr2 = _trainer(_model(ELASTIC, init), mesh, "zero", batches, ckpt_dir,
                   2 * STEPS, 0, **RESUME)
    start = tr2.restore_or_init()
    restored = _state(tr2.gathered_state_tree())
    with collectives.count_collectives() as calls:
        _, _, l2 = tr2.run()
    return {"l1": l1, "saved": saved, "start": start, "restored": restored,
            "l2": l2, "grams": sum(c.kind == "gram" for c in calls),
            "layouts": {k: tuple(p.shape) for k, p in
                        tr2.model.named_parameters()}}


def _ranks(rank, world, inits, batches, ckpt_dir, out_dir):
    mesh = tmesh.make_debug_mesh(data=2, model=2)
    res = {f"{arch}/{strategy}": _grads(arch, strategy, inits[arch],
                                        batches[0], mesh)
           for arch in ARCHS for strategy in STRATEGIES}
    res["elastic"] = _elastic(inits[ELASTIC], batches, mesh, ckpt_dir)
    torch_world.save(out_dir, rank, res)


def _jax_losses(inits, batches):
    """The JAX package's loss of each arch on batch 0, and the losses of
    its unsharded train step for STEPS steps of the elastic arch."""
    out = {}
    for arch in ARCHS:
        jm = build(jsmoke(arch).replace(**CFG32))
        loss, _ = jm.loss(jax.tree.map(jnp.asarray, inits[arch]),
                          {"tokens": jnp.asarray(batches[0], jnp.int32)})
        out[arch] = float(loss)
    jm = build(jsmoke(ELASTIC).replace(**CFG32))
    ocfg = JOpt(name="muon", learning_rate=0.02, prism=JPrism(**PRISM5))
    opt = jmake_optimizer(ocfg, jm.logical_axes())
    p = master_params(jax.tree.map(jnp.asarray, inits[ELASTIC]))
    s = opt.init(p)
    step = jax.jit(jmake_train_step(jm, opt, ocfg))
    losses = []
    for t, b in enumerate(batches):
        p, s, m = step(p, s, {"tokens": jnp.asarray(b, jnp.int32)}, t)
        losses.append(float(m["loss"]))
    out["train"] = losses
    return out


def _one_process(inits, batches):
    out = {}
    for arch in ARCHS:
        model = _model(arch, inits[arch], **CFG32)
        loss, _ = model.loss({"tokens": torch.from_numpy(batches[0])})
        loss.backward()
        out[arch] = (float(loss.detach()), {k: _np(p.grad)
                                   for k, p in model.named_parameters()})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("model_axis")
    inits, batches = _inputs()
    ckpt_dir = str(out / "ckpt")
    ctx = torch_world.start_world(_ranks, WORLD, out, inits, batches,
                                  ckpt_dir, str(out))
    ref = _jax_losses(inits, batches)
    one = _one_process(inits, batches)
    torch_world.join_world(ctx)
    return (inits, batches, ckpt_dir, ref, one,
            [torch_world.load(out, r) for r in range(WORLD)])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_one_process(world, arch, strategy):
    one, ranks = world[4], world[5]
    want_loss, want = one[arch]
    for r in ranks:
        loss, grads, kinds = r[f"{arch}/{strategy}"]
        np.testing.assert_allclose(loss, want_loss, rtol=TOL, atol=TOL)
        assert set(grads) == set(want)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        # tensor parallelism reduces over the model axis only under "tp"
        assert ("tp" in kinds) == (strategy == "tp")
        assert "fsdp" in kinds


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference(world, arch):
    ref, ranks = world[3], world[5]
    for strategy in STRATEGIES:
        for r in ranks:
            np.testing.assert_allclose(r[f"{arch}/{strategy}"][0], ref[arch],
                                       rtol=JAX_TOL, atol=JAX_TOL)


def test_elastic_tp_then_zero(world):
    """tp at fp32 against the JAX package's unsharded step; the resume
    under zero restores every leaf bitwise, keeps improving and lies near
    one process resuming the same checkpoint with bf16 gradients."""
    inits, batches, ckpt_dir, ref, _, ranks = world
    for r in ranks:
        e = r["elastic"]
        np.testing.assert_allclose(e["l1"], ref["train"], rtol=JAX_TOL,
                                   atol=JAX_TOL)
        assert e["start"] == STEPS
        assert set(e["restored"]) == set(e["saved"])
        for k, v in e["saved"].items():
            np.testing.assert_array_equal(e["restored"][k], v, err_msg=k)
        assert all(np.isfinite(e["l2"])) and e["l2"][-1] < e["l1"][0]
        assert e["grams"] > 0  # the local reshard ran its Gram all-reduce
        assert e["l2"] == ranks[0]["elastic"]["l2"]
    # under zero every leaf is a block of its (data, model) split
    assert ranks[0]["elastic"]["layouts"]["embed"] == (256, 16)
    one = _trainer(_model(ELASTIC, inits[ELASTIC]), None, "zero", batches,
                   ckpt_dir, 2 * STEPS, 0, **RESUME)
    _, _, losses = one.run()
    np.testing.assert_allclose(ranks[0]["elastic"]["l2"], losses, rtol=0,
                               atol=BF16_LOSS_TOL)


def test_one_process_restores_the_world_checkpoint(world):
    inits, batches, ckpt_dir, _, _, ranks = world
    want = ranks[0]["elastic"]["saved"]
    for r in ranks[1:]:
        for k, v in r["elastic"]["saved"].items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    tr = _trainer(_model(ELASTIC, inits[ELASTIC], **CFG32), None, "tp",
                  batches, ckpt_dir, STEPS, 0)
    assert tr.restore_or_init() == STEPS
    got = _state(tr.state_tree())
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ------------------------------------------------------------ no world

def _mesh(name):
    shape, multi_pod = MESHES[name]
    if multi_pod:
        return tmesh.make_debug_mesh(*shape, multi_pod=True)
    return tmesh.make_debug_mesh(*shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_blocks_cover_every_leaf(mesh_name):
    """For the ten configs under both strategies: each leaf's block shape
    times its split is the whole shape (at the published widths), and
    every rank's block of a SMOKE leaf (``local_block`` on numpy) is a
    block of it, every element held by as many ranks as the layout
    replicates it over."""
    mesh = _mesh(mesh_name)
    ranks = [mesh.coords(r) for r in range(mesh.size)]
    for arch in arch_ids():
        for strategy in STRATEGIES:
            for cfg, check in ((get_config(arch), False),
                               (get_smoke_config(arch), True)):
                specs = param_specs(cfg)
                shards = sharding.tree_shardings(
                    mesh, {k: a for k, (_, a, _) in specs.items()},
                    sharding.param_rules(cfg, mesh, strategy),
                    {k: s for k, (s, _, _) in specs.items()})
                for k, (shape, _, _) in specs.items():
                    sh = shards[k]
                    local = sharding.local_shape(shape, sh)
                    assert sharding.full_shape(local, sh) == tuple(shape)
                    if not check:
                        continue
                    arr = np.arange(int(np.prod(shape))).reshape(shape)
                    seen = np.concatenate([
                        sharding.local_block(arr, sh, c).reshape(-1)
                        for c in ranks])
                    count = np.bincount(seen, minlength=arr.size)
                    split = sharding.sharded_axes(sh)
                    replicas = mesh.size // int(np.prod(
                        [mesh.shape[a] for a in split]))
                    assert np.all(count == replicas), \
                        (arch, strategy, k, sh.spec)


def test_production_layout_without_a_world():
    from repro_torch.launch import train

    for arch in ("gpt2-paper", "qwen3-14b"):
        cfg = get_config(arch)
        mesh, shards = train.production_layout(cfg)
        assert mesh.shape == {"data": 16, "model": 16}
        p = shards["params"]
        assert p["embed"].spec == ("model", "data")
        assert p["layers.attn.wq"].spec == (None, "data", "model", None)
        assert p["layers.attn.wk"].spec == (None, "data", None, None)
        assert p["layers.mlp.w_down"].spec == (None, "model", "data")
        for k, (shape, _, _) in param_specs(cfg).items():
            local = sharding.local_shape(shape, p[k])
            assert sharding.full_shape(local, p[k]) == tuple(shape)
    # the moe family: granite by expert parallelism (32 experts, 2 a
    # model rank), mixtral by each expert's expert_mlp columns; granite's
    # padded vocab (49,155 -> 49,168) splits over the model axis
    for arch, w_up, embed in (
            ("granite-moe-1b-a400m", (None, "model", "data", None),
             (3073, 64)),
            ("mixtral-8x7b", (None, None, "data", "model"), (2000, 256))):
        cfg = get_config(arch)
        mesh, shards = train.production_layout(cfg)
        p = shards["params"]
        specs = param_specs(cfg)
        assert p["layers.moe.w_up"].spec == w_up
        assert p["layers.moe.router"].spec == (None, "data", None)
        assert p["embed"].spec == ("model", "data")
        assert sharding.local_shape(specs["embed"][0], p["embed"]) == embed
        for k, (shape, _, _) in specs.items():
            local = sharding.local_shape(shape, p[k])
            assert sharding.full_shape(local, p[k]) == tuple(shape)
    mesh, shards = train.production_layout(get_config("gpt2-paper"),
                                           multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_production_mesh_refuses_a_world_of_the_wrong_size(monkeypatch):
    from repro_torch.launch import train

    argv = ["--arch", "gpt2-paper", "--smoke", "--steps", "1", "--seq",
            "16", "--batch", "2", "--device", "cpu", "--mesh", "production"]
    for k in tmesh.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="no world in the environment"):
        train.main(argv)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        with pytest.raises(ValueError, match="needs 256 ranks; the world "
                                             "has 1"):
            train.main(argv)
    finally:
        tmesh.close_world()
