"""Data-parallel training in a world of 2 ranks on gloo against one
process and the JAX package (counterpart of tests/test_sharded_train.py,
its widths: the qwen3-14b SMOKE config, d_model 64, 4 heads, 2 kv heads,
head_dim 16, at seq 32 and global batch 8).

Each rank trains 3 steps on its own 4 rows; the gradients and the loss
are averaged over the data group and Muon's polars shard over the ranks.
In fp32 (the model's compute dtype too), with ``grads_dtype="bfloat16"``
and with ``gradient_compression="int8"``, the losses and parameters of
every rank match the single-process port and the JAX package's
single-device step at 1e-4, the tolerance of
tests/test_torch_train.py's three-step parity test.  With int8
compression the losses are held there too, but the parameters by their
update's relative norm at 2e-2 (the norm-level bound
tests/test_sharded_precond.py gives a perturbed Muon chain): an fp32
rounding difference of a reduced gradient moves its int8 code by a whole
step wherever x / scale lands within ~1e-7 of a half, a few entries a
step, and Muon's polar spreads each such step over the whole matrix.  A
bf16 model with bf16 gradients reduces them as bf16; its losses are held
to the single-process port's and to the JAX package's bf16-gradient step
at BF16_LOSS_TOL (5e-3) in the loss: CPU bf16 GEMMs round differently at
each batch size and in each package, which leaves the sound runs at most
1.25e-3 apart, while a run that applies no update reads 2.5e-2 (the
test holds that it does).  A checkpoint written by the world of 2
restores bitwise in one process (and a leaf restored as sharded over the
data axis gives each rank its own rows); a run stopped and resumed on
the mesh, Muon with precond_every 5 and Shampoo, is bitwise an
uninterrupted one.  A moe model on the mesh
(tests/test_torch_moe_mesh.py) and a dense model on a model axis
(tests/test_torch_model_axis.py) train, and so does an ssm model on a
model axis (tests/test_torch_family_mesh.py), so outside a world their
Trainers ask for the process group.
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
from repro_torch import checkpoint as ckpt
from repro_torch import collectives, convert
from repro_torch.config import OptimizerConfig, PrismConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.optim.base import PENDING_STATE_KEYS
from repro_torch.train import Trainer, make_train_step
from test_torch_prism import JaxKey
import torch_world
import torch_threads  # noqa: F401  (the worker's share of the cores)

WORLD = 2
TOL = 1e-4             # tests/test_torch_train.py
BF16_LOSS_TOL = 5e-3
INT8_UPDATE_TOL = 2e-2
STEPS, BATCH, SEQ = 3, 8, 32
PRISM = dict(degree=2, iterations=2, warm_alpha_iters=1, sketch_dim=4)
CFG32 = dict(dtype="float32", emb_dtype="float32")
RESUME = {"muon_every5": dict(precond_every=5),
          "shampoo": dict(name="shampoo", max_precond_dim=256)}
RESUME_AT, RESUME_STEPS = 2, 4
VARIANTS = {"fp32": {}, "bf16_grads": dict(grads_dtype="bfloat16"),
            "int8": dict(gradient_compression="int8")}


def _ocfg(**kw):
    kw.setdefault("name", "muon")
    return OptimizerConfig(learning_rate=0.02,
                           prism=PrismConfig(use_kernels=True, **PRISM), **kw)


def _inputs():
    cfg = jsmoke("qwen3-14b").replace(**CFG32)
    init = jax.tree.map(np.asarray, build(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int64)
               for _ in range(STEPS)]
    return init, batches


def _model(init, **cfg_kw):
    cfg = get_smoke_config("qwen3-14b").replace(**cfg_kw)
    model = Model(cfg, device="cpu")
    model.load_params(convert.params_from_jax(init, cfg))
    return model


def _run(init, batches, mesh, rows, cfg_kw=CFG32, **okw):
    """(losses, params, gradient all-reduce dtypes) of STEPS steps."""
    model = _model(init, **cfg_kw)
    ocfg = _ocfg(**okw)
    opt = make_optimizer(ocfg, model.named_parameters(),
                         model.logical_axes())
    step = make_train_step(model, opt, ocfg, key=JaxKey(jax.random.PRNGKey(0)),
                           mesh=mesh)
    losses = []
    with collectives.count_collectives() as calls:
        for t, b in enumerate(batches):
            m = step({"tokens": torch.from_numpy(b[rows])}, t)
            losses.append(float(m["loss"]))
    return (losses, {k: p.detach().numpy().copy()
                     for k, p in model.named_parameters()},
            sorted({str(c.dtype) for c in calls
                    if c.op == "all_reduce_sum" and c.numel > 3}))


def _state(trainer):
    return {k: (v.detach().float().numpy().copy()
                if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in convert._flatten(trainer.state_tree()).items()}


def _ranks(rank, world, init, batches, ckpt_dir, out_dir):
    mesh = tmesh.make_debug_mesh(data=world, model=1)
    per = BATCH // world
    rows = slice(rank * per, (rank + 1) * per)
    res = {v: _run(init, batches, mesh, rows, **kw)
           for v, kw in VARIANTS.items()}
    res["bf16_model"] = _run(init, batches, mesh, rows, cfg_kw={},
                             grads_dtype="bfloat16")
    model = _model(init, **CFG32)
    tr = Trainer(model, _ocfg(), TrainConfig(
        steps=STEPS, checkpoint_dir=ckpt_dir, checkpoint_every=STEPS),
        DataConfig(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                   global_batch=BATCH),
        mesh=mesh, batch_fn=lambda t: {"tokens": torch.from_numpy(
            batches[t])})
    _, _, res["trainer_losses"] = tr.run()
    res["trainer_state"] = _state(tr)
    # elastic restore of a batch-sharded leaf: each rank its own rows
    emb = tr.model.embed
    half = torch.empty((emb.shape[0] // world,) + tuple(emb.shape[1:]))
    _, part = ckpt.restore(ckpt_dir, {"params": {"embed": half}},
                           shardings={"params": {"embed": sharding.named(
                               mesh, ("data", None))}})
    res["embed_rows"] = part["params"]["embed"].numpy()
    res["resume"] = {kind: _resume_runs(init, batches, mesh, kind,
                                        f"{ckpt_dir}_{kind}")
                     for kind in RESUME}
    torch_world.save(out_dir, rank, res)


def _resume_trainer(init, batches, mesh, kind, steps, ckpt_dir):
    model = _model(init, **CFG32)
    return Trainer(model, _ocfg(**RESUME[kind]), TrainConfig(
        steps=steps, checkpoint_dir=ckpt_dir,
        checkpoint_every=RESUME_AT, async_checkpoint=False),
        DataConfig(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                   global_batch=BATCH),
        mesh=mesh, batch_fn=lambda t: {"tokens": torch.from_numpy(
            batches[t % STEPS])})


def _resume_runs(init, batches, mesh, kind, ckpt_dir):
    """A run on the mesh stopped at step RESUME_AT and resumed by a new
    Trainer on the mesh, beside an uninterrupted one; then each cached
    preconditioner of the checkpoint restored as the block its
    ``precond_cache_sharding`` names (an axis of size 1, the model axis
    here, splits nothing)."""
    _resume_trainer(init, batches, mesh, kind, RESUME_AT, ckpt_dir).run()
    tr = _resume_trainer(init, batches, mesh, kind, RESUME_STEPS, ckpt_dir)
    start = tr.restore_or_init()
    _, _, losses = tr.run()
    full = _resume_trainer(init, batches, mesh, kind, RESUME_STEPS, None)
    _, _, full_losses = full.run()
    rank = collectives.rank(None)
    blocks = {}
    _, saved = ckpt.restore(ckpt_dir, tr.state_tree(), step=RESUME_AT,
                            allow_missing=PENDING_STATE_KEYS)
    for name, slot in saved["opt"].items():
        for sk, v in (slot.items() if isinstance(slot, dict) else ()):
            if sk not in sharding.PRECOND_CACHE_STATE_KEYS or v.dim() < 2:
                continue
            sh = sharding.precond_cache_sharding(mesh, tuple(v.shape))
            dim = v.dim() - 2
            n = mesh.shape["data"] if "data" in sharding.axes_of(
                sh.spec[dim] if dim < len(sh.spec) else None) else 1
            want = v.narrow(dim, rank * (v.shape[dim] // n),
                            v.shape[dim] // n)
            _, got = ckpt.restore(
                ckpt_dir, {"opt": {name: {sk: torch.empty_like(want)}}},
                step=RESUME_AT, shardings={"opt": {name: {sk: sh}}})
            blocks[f"{name}.{sk}"] = (tuple(sh.spec), n, bool(
                torch.equal(got["opt"][name][sk], want)))
    return {"start": start, "losses": losses, "full_losses": full_losses,
            "state": _state(tr), "full_state": _state(full),
            "blocks": blocks}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train")
    init, batches = _inputs()
    ckpt_dir = str(out / "ckpt")
    torch_world.run_world(_ranks, WORLD, out, init, batches, ckpt_dir,
                          str(out))
    return init, batches, ckpt_dir, [torch_world.load(out, r)
                                     for r in range(WORLD)]


def _jax_run(init, batches, cfg_kw=CFG32, **okw):
    cfg = jsmoke("qwen3-14b").replace(**cfg_kw)
    model = build(cfg)
    ocfg = JOpt(name="muon", learning_rate=0.02, prism=JPrism(**PRISM),
                **okw)
    opt = jmake_optimizer(ocfg, model.logical_axes())
    p = master_params(jax.tree.map(jnp.asarray, init))
    s = opt.init(p)
    step = jax.jit(jmake_train_step(model, opt, ocfg))
    losses = []
    for t, b in enumerate(batches):
        p, s, m = step(p, s, {"tokens": jnp.asarray(b, jnp.int32)}, t)
        losses.append(float(m["loss"]))
    return losses, convert._flatten(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_world_matches_one_process_and_reference(world, variant):
    init, batches, _, ranks = world
    losses, params, dtypes = ranks[0][variant]
    for r in ranks[1:]:
        assert r[variant][0] == losses
        for k in params:
            np.testing.assert_array_equal(r[variant][1][k], params[k])
    assert dtypes == ["torch.float32"]
    one_losses, one_params, _ = _run(init, batches, None, slice(None),
                                     **VARIANTS[variant])
    jlosses, jparams = _jax_run(init, batches, **VARIANTS[variant])
    init_flat = convert._flatten(init)
    np.testing.assert_allclose(losses, one_losses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    for k in params:
        for want in (one_params[k], jparams[k]):
            if variant != "int8":
                np.testing.assert_allclose(params[k], want, rtol=TOL,
                                           atol=TOL, err_msg=k)
                continue
            p0 = init_flat[k]
            rel = np.linalg.norm(params[k] - want) / max(
                np.linalg.norm(want - p0), 1e-12)
            assert rel <= INT8_UPDATE_TOL, (k, rel)


def test_bf16_gradients_reduce_in_bf16(world):
    """The bf16 model's world run against one process and the JAX
    package's bf16-gradient step, in the loss; the bound is one that a
    run applying no update leaves."""
    init, batches, _, ranks = world
    losses, _, dtypes = ranks[0]["bf16_model"]
    assert ranks[1]["bf16_model"][0] == losses
    assert dtypes == ["torch.bfloat16", "torch.float32"]
    one_losses, _, _ = _run(init, batches, None, slice(None), cfg_kw={},
                            grads_dtype="bfloat16")
    jlosses, _ = _jax_run(init, batches, cfg_kw={}, grads_dtype="bfloat16")
    assert np.all(np.isfinite(losses))
    for want in (one_losses, jlosses):
        np.testing.assert_allclose(losses, want, rtol=0,
                                   atol=BF16_LOSS_TOL)
    model = _model(init)
    with torch.no_grad():
        still = [float(model.loss({"tokens": torch.from_numpy(b)})[0])
                 for b in batches]
    gap = {what: max(abs(a - b) for a, b in zip(losses, want))
           for what, want in (("one process", one_losses), ("jax", jlosses),
                              ("no update", still))}
    print(f"bf16 model, loss gaps of the world: {gap}")
    assert gap["no update"] > BF16_LOSS_TOL


def test_world_checkpoint_restores_bitwise_in_one_process(world):
    """Rank 0 wrote the step-3 checkpoint; one process (no process group)
    restores the ranks' parameters, optimizer state and count bitwise."""
    init, batches, ckpt_dir, ranks = world
    want = ranks[0]["trainer_state"]
    for k, v in ranks[1]["trainer_state"].items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    model = _model(init, **CFG32)
    tr = Trainer(model, _ocfg(), TrainConfig(checkpoint_dir=ckpt_dir),
                 DataConfig(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH))
    assert tr.restore_or_init() == STEPS
    got = _state(tr)
    assert set(got) == set(want) and int(got["opt.count"]) == STEPS
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert ranks[0]["trainer_losses"] == ranks[1]["trainer_losses"]
    # a leaf sharded over the data axis restores as each rank's rows
    embed = want["params.embed"]
    rows = embed.shape[0] // WORLD
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["embed_rows"],
                                      embed[r * rows:(r + 1) * rows])


@pytest.mark.parametrize("kind", list(RESUME))
def test_world_resumes_on_the_mesh_bitwise(world, kind):
    """A run stopped at step RESUME_AT and resumed on the mesh is bitwise
    an uninterrupted one on every rank, caches shaped unlike their
    parameters included (Muon's matrix views with precond_every 5,
    Shampoo's non-square factors' roots); restored under its
    ``precond_cache_sharding``, each cache gives each rank its rows of
    the data axis and splits nothing over the model axis of size 1."""
    ranks = world[3]
    for r in ranks:
        res = r["resume"][kind]
        assert res["start"] == RESUME_AT
        assert res["losses"] == res["full_losses"][RESUME_AT:]
        assert set(res["state"]) == set(res["full_state"])
        for k, v in res["state"].items():
            np.testing.assert_array_equal(v, res["full_state"][k],
                                          err_msg=k)
        assert res["blocks"], "no cached preconditioner in the state"
        for k, (spec, n, equal) in res["blocks"].items():
            assert equal, (k, spec, n)
        blocks = res["blocks"].values()
        assert any(n == WORLD for _, n, _ in blocks)
        assert any(spec[:2] == ("model", "data") for spec, _, _ in blocks)
    for k, v in ranks[0]["resume"][kind]["state"].items():
        np.testing.assert_array_equal(ranks[1]["resume"][kind]["state"][k],
                                      v, err_msg=k)


def test_moe_and_model_axis_raise_item_11b():
    """Items 11b and 11e's moe half are done: a moe model on a data mesh
    and a dense one on a data and model mesh are taken, and outside a
    world their Trainers need the process group, and so does an ssm
    model on a data and model mesh (item 11h is done: it raised before);
    pipeline stages raise item 11c."""
    dcfg = DataConfig(vocab_size=256, seq_len=SEQ, global_batch=BATCH)
    moe = Model(get_smoke_config("granite-moe-1b-a400m"), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        Trainer(moe, _ocfg(), TrainConfig(), dcfg,
                mesh=tmesh.make_debug_mesh(data=2, model=1))
    ssm = Model(get_smoke_config("falcon-mamba-7b"), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        Trainer(ssm, _ocfg(), TrainConfig(), dcfg,
                mesh=tmesh.make_debug_mesh(data=2, model=2))
    dense = Model(get_smoke_config("qwen3-14b"), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        Trainer(dense, _ocfg(), TrainConfig(), dcfg,
                mesh=tmesh.make_debug_mesh(data=2, model=2))
    with pytest.raises(NotImplementedError, match="item 11c"):
        Trainer(dense, _ocfg(), TrainConfig(pipeline_stages=2), dcfg)


def test_launcher_compression_and_unported_meshes(monkeypatch):
    """``launch/train.py --compression int8`` trains; ``--mesh
    production`` joins the world the environment names (none here) and
    ``--multi_pod`` needs it; pipeline stages raise item 11c."""
    from repro_torch.launch import train

    for k in tmesh.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    argv = ["--arch", "qwen3-14b", "--smoke", "--steps", "1", "--seq", "16",
            "--batch", "2", "--device", "cpu"]
    losses = train.main(argv + ["--compression", "int8"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    for extra, err, match in (
            (["--mesh", "production"], ValueError, "no world"),
            (["--multi_pod"], ValueError, "needs --mesh production"),
            (["--pipeline_stages", "2"], NotImplementedError, "item 11c")):
        with pytest.raises(err, match=match):
            train.main(argv + extra)
