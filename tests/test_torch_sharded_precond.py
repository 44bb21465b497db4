"""The §8 batch-sharded preconditioner engine in a world of 4 ranks on gloo
(counterpart of tests/test_sharded_precond.py:20-166 and the sharded
cases of tests/test_async_precond.py:280-300, :375).

One world runs every case (``world``); each rank saves what it computed
and the tests hold it against the JAX package's single-device result,
computed here from the same numpy inputs with the same sketches
(``JaxKey``), at the reference's sharded-vs-replicated tolerances: fp32
polars, roots and updates 2e-5; the bf16 policy's polars rtol 0.05, atol
1.5·2⁻⁸, its Muon and Shampoo updates 2e-2 and 5e-2 in relative norm.
The B = 6 bucket does not divide the 4 ranks: it pads to 8 with identity
slices, and a (48, 44) view merges into the (48, 48) bucket through the
``n_real`` correction.  Every rank must hold the same results bitwise,
issue one all-gather a bucket, and call the kernel wrappers exactly as
often as a single process does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.optim import base as jbase
from repro.optim import bucketing as jbucketing
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import collectives
from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding
from repro_torch.optim import base, bucketing, make_optimizer
from repro_torch.sharding_ctx import activation_sharding
from repro_torch.train.state import opt_state_shardings
from test_torch_muon import count_ops
from test_torch_prism import JaxKey
import torch_world
import torch_threads  # noqa: F401  (the worker's share of the cores)

WORLD = 4
TOL = 2e-5
BF16_RTOL, BF16_ATOL = 0.05, 1.5 * 2.0 ** -8
RULES = {"opt_layers": "model", "opt_rows": "data"}
SHAPES = [(3, 64, 32), (64, 32), (64, 32), (64, 32), (48, 48), (48, 44)]
POLAR = dict(degree=2, iterations=6, warm_alpha_iters=1, sketch_dim=8)
UPDATE = dict(degree=2, iterations=5, warm_alpha_iters=1, sketch_dim=8)
ROOTS = dict(degree=2, iterations=8, sketch_dim=8)
AXES = {"w": ("layers", "embed", "mlp"), "v": ("embed", "mlp"),
        "b": ("embed",)}
SQ_AXES = {"a": ("embed", "mlp"), "c": ("embed",)}
ASYNC = dict(degree=2, iterations=4, warm_alpha_iters=1, sketch_dim=8)
ASYNC_STEPS = 7
DRIFT_STEPS = 30


def _inputs():
    rng = np.random.default_rng(0)
    views = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    params = {"w": views[0], "v": views[4],
              "b": np.ones((64,), np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    # Shampoo's bf16 case on a full-rank factor (the reference's
    # controlled spectrum): U diag(sig) V^T, sig log-spaced in [0.3, 1]
    sig = np.exp(np.linspace(np.log(0.3), 0.0, 48)).astype(np.float32)
    u, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    v, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    sq_params = {"a": views[4], "c": np.ones((64,), np.float32)}
    sq_grads = {"a": ((u * sig) @ v.T).astype(np.float32),
                "c": np.ones((64,), np.float32)}
    return dict(views=views, params=params, grads=grads,
                sq_params=sq_params, sq_grads=sq_grads,
                async_params={k: rng.standard_normal(s).astype(np.float32)
                              for k, s in (("w1", (64, 32)),
                                           ("w3", (3, 48, 32)),
                                           ("b", (64,)))})


def _async_grads(params, t, scale=0.1, seed=1):
    rng = np.random.default_rng(seed * 1000 + t)
    return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params.items()}


ASYNC_AXES = {"w1": ("embed", "mlp"), "w3": ("layers", "embed", "mlp"),
              "b": ("embed",)}


def _key(i=0):
    return jax.random.PRNGKey(i)


# ------------------------------------------------------------ the ranks

def _np(t):
    return t.detach().float().numpy()


def _update(name, prism, lr, params, grads, axes, mesh, **kw):
    """(updated params, kernel-wrapper calls) of one port step under the
    mesh; every config draws from PRNGKey(0)."""
    cfg = OptimizerConfig(name=name, learning_rate=lr, max_precond_dim=256,
                          prism=PrismConfig(use_kernels=True, **prism), **kw)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in params.items()]
    opt = make_optimizer(cfg, named, axes)
    for k, p in named:
        p.grad = torch.from_numpy(grads[k].copy())
    with activation_sharding(mesh, RULES), count_ops() as calls:
        opt.step(key=JaxKey(_key()))
    return {k: _np(p) for k, p in named}, dict(calls)


def _async_run(params, grads_of, steps, mesh, cfg_kw, drift_from_state):
    """A Muon async run: the service's phase 1 and the step, under the
    mesh; returns (params, counters after each step, dispatch steps)."""
    cfg = OptimizerConfig(name="muon", precond_async=True,
                          prism=PrismConfig(use_kernels=True, **ASYNC),
                          **cfg_kw)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in params.items()]
    opt = make_optimizer(cfg, named, ASYNC_AXES)
    svc = base.AsyncPrecondService(opt)
    counters, dispatched = [], []
    for t in range(steps):
        with activation_sharding(mesh, RULES):
            drift = float(base.precond_drift(opt)) if drift_from_state \
                else 0.0
            svc.step_begin(t, JaxKey(jax.random.fold_in(_key(7), t)),
                           drift=drift)
            if svc.last_dispatch == t:
                dispatched.append(t)
            for k, p in named:
                p.grad = torch.from_numpy(grads_of(t)[k])
            opt.step(key=JaxKey(_key(t)), refresh=False)
        counters.append(dict(svc.counters))
    return {k: _np(p) for k, p in named}, counters, dispatched


DRIFT_KW = dict(learning_rate=0.05, precond_every=1000, matfn_tol=1e-2,
                precond_drift_slack=1.5, momentum=0.5,
                precond_swap_delay=1)
ASYNC_KW = dict(learning_rate=0.05, precond_every=3, precond_swap_delay=1)


def _drift_grads(params):
    return lambda t: _async_grads(params, t if t >= 24 else 0,
                                  scale=3.0 if t >= 24 else 0.1, seed=3)


def _ranks(rank, world, inp, out_dir):
    mesh = tmesh.make_debug_mesh(data=world, model=1)
    views = [torch.from_numpy(v) for v in inp["views"]]
    res = {}
    cfg = OptimizerConfig(prism=PrismConfig(use_kernels=True, **POLAR),
                          bucket_pad=True)
    with activation_sharding(mesh, RULES):
        m, axes = bucketing.mesh_batch_axes(cfg)
        res["axes"] = (m is mesh, axes)
        with collectives.count_collectives() as calls, \
                count_ops() as ops_calls:
            res["polar"] = [_np(o) for o in bucketing.polar_bucketed(
                views, cfg, JaxKey(_key()))]
        res["polar_gathers"] = [(c.op, c.dtype, c.numel) for c in calls]
        res["polar_ops"] = dict(ops_calls)
        cfg16 = OptimizerConfig(prism=PrismConfig(use_kernels=True, **POLAR),
                                bucket_pad=True, matfn_dtype="bfloat16")
        res["polar16"] = [(_np(o), str(o.dtype)) for o in
                          bucketing.polar_bucketed(views, cfg16,
                                                   JaxKey(_key()))]
        cfgt = OptimizerConfig(prism=PrismConfig(use_kernels=True,
                                                 tol=2e-2, **POLAR),
                               bucket_pad=True)
        with collectives.count_collectives() as calls:
            outs, its, sts = bucketing.polar_bucketed(
                views, cfgt, JaxKey(_key()), with_iters=True)
        res["tele"] = ([_np(o) for o in outs],
                       [i.numpy() for i in its], [s.numpy() for s in sts])
        res["tele_gathers"] = [(c.op, str(c.dtype)) for c in calls]
    # single-process wrapper calls of the same polar (no context)
    with count_ops() as ops_calls:
        bucketing.polar_bucketed(views, cfg, JaxKey(_key()))
    res["polar_ops_single"] = dict(ops_calls)

    res["muon"] = _update("muon", UPDATE, 0.05, inp["params"], inp["grads"],
                          AXES, mesh)
    res["shampoo"] = _update("shampoo", ROOTS, 1e-3, inp["params"],
                             inp["grads"], AXES, mesh)
    res["muon16"] = _update("muon", UPDATE, 0.05, inp["params"],
                            inp["grads"], AXES, mesh,
                            matfn_dtype="bfloat16", precond_every=2)
    res["shampoo16"] = _update("shampoo", UPDATE, 1e-3, inp["sq_params"],
                               inp["sq_grads"], SQ_AXES, mesh,
                               matfn_dtype="bfloat16", precond_every=2)
    ap = inp["async_params"]
    res["async"] = _async_run(ap, lambda t: _async_grads(ap, t),
                              ASYNC_STEPS, mesh, ASYNC_KW, False)
    res["drift"] = _async_run(ap, _drift_grads(ap), DRIFT_STEPS, mesh,
                              DRIFT_KW, True)
    torch_world.save(out_dir, rank, res)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, each rank's results, the reference's results); the
    reference runs here while the ranks run."""
    out = tmp_path_factory.mktemp("sharded_precond")
    inp = _inputs()
    ctx = torch_world.start_world(_ranks, WORLD, out, inp, str(out))
    refs = _references(inp)
    torch_world.join_world(ctx)
    return inp, [torch_world.load(out, r) for r in range(WORLD)], refs


# ------------------------------------------------------- the reference

def _jpolar(inp, cfg, **kw):
    """The reference's unsharded ``polar_bucketed`` (jitted)."""
    return jax.jit(lambda vs: jbucketing.polar_bucketed(vs, cfg, _key(),
                                                        **kw))(
        [jnp.asarray(v) for v in inp["views"]])


def _jupdate(name, prism, lr, params, grads, axes, **kw):
    cfg = JOpt(name=name, learning_rate=lr, max_precond_dim=256,
               prism=JPrism(**prism), **kw)
    opt = jmake_optimizer(cfg, axes)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    out, _ = jax.jit(opt.update)(g, opt.init(p), p, 0, _key())
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _jasync(params, grads_of, steps, cfg_kw, drift_from_state):
    cfg = JOpt(name="muon", precond_async=True, prism=JPrism(**ASYNC),
               **cfg_kw)
    opt = jmake_optimizer(cfg, ASYNC_AXES)
    svc = jbase.AsyncPrecondService(opt, cfg)
    step = jax.jit(opt.update, static_argnums=(5,))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = opt.init(p)
    counters = []
    for t in range(steps):
        drift = float(jbase.precond_drift(s)) if drift_from_state else 0.0
        s = svc.step_begin(s, t, jax.random.fold_in(_key(7), t),
                           drift=drift)
        g = {k: jnp.asarray(v) for k, v in grads_of(t).items()}
        p, s = step(g, s, p, t, _key(t), False)
        counters.append(dict(svc.counters))
    return {k: np.asarray(v) for k, v in p.items()}, counters


def _references(inp):
    """The JAX package's single-device results of every case."""
    views = inp["views"]
    ap = inp["async_params"]
    refs = {
        "polar": _jpolar(inp, JOpt(prism=JPrism(**POLAR), bucket_pad=True)),
        "polar16": _jpolar(inp, JOpt(prism=JPrism(**POLAR), bucket_pad=True,
                                     matfn_dtype="bfloat16")),
        "tele": _jpolar(inp, JOpt(prism=JPrism(tol=2e-2, **POLAR),
                                  bucket_pad=True), with_iters=True),
        "muon": _jupdate("muon", UPDATE, 0.05, inp["params"], inp["grads"],
                         AXES),
        "shampoo": _jupdate("shampoo", ROOTS, 1e-3, inp["params"],
                            inp["grads"], AXES),
        "muon16": _jupdate("muon", UPDATE, 0.05, inp["params"],
                           inp["grads"], AXES, matfn_dtype="bfloat16",
                           precond_every=2),
        "shampoo16": _jupdate("shampoo", UPDATE, 1e-3, inp["sq_params"],
                              inp["sq_grads"], SQ_AXES,
                              matfn_dtype="bfloat16", precond_every=2),
        "async": _jasync(ap, lambda t: _async_grads(ap, t), ASYNC_STEPS,
                         ASYNC_KW, False),
        "drift": _jasync(ap, _drift_grads(ap), DRIFT_STEPS, DRIFT_KW, True)}
    assert len(views) == len(SHAPES)
    return refs


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_equal(r[key], first, err_msg=key)


# ------------------------------------------------------------ the tests

def test_engine_is_on_for_the_data_axis(world):
    _, ranks, _ = world
    assert all(r["axes"] == (True, ("data",)) for r in ranks)


def test_sharded_polars_match_single_device_reference(world):
    """B = 6 (padded to 8 with identity slices), a square bucket and the
    n_real merge, against the reference's unsharded ``polar_bucketed``."""
    _, ranks, refs = world
    ref = refs["polar"]
    _same_on_every_rank(ranks, "polar")
    for r, o in zip(ref, ranks[0]["polar"]):
        np.testing.assert_allclose(o, np.asarray(r), rtol=TOL, atol=TOL)


def test_one_all_gather_a_bucket_and_single_process_wrapper_calls(world):
    """Each bucket's polars cross the ranks in one fp32 all-gather of the
    rank's padded share, and each rank calls every kernel wrapper as
    often as a single process does (one call a bucket an iteration)."""
    inp, ranks, _ = world
    plan = bucketing.plan_buckets([v.shape for v in inp["views"]],
                                  pad=True)
    for r in ranks:
        want = [("all_gather", torch.float32,
                 -(-b.size // WORLD) * b.shape[0] * b.shape[1])
                for b in plan]
        assert r["polar_gathers"] == want
        assert r["polar_ops"] == r["polar_ops_single"]
        assert sum(r["polar_ops"].values()) > 0


def test_bf16_policy_polars_match_reference(world):
    _, ranks, refs = world
    ref = refs["polar16"]
    _same_on_every_rank(ranks, "polar16")
    for r, (o, dt) in zip(ref, ranks[0]["polar16"]):
        assert dt == "torch.bfloat16" and r.dtype == jnp.bfloat16
        np.testing.assert_allclose(o, np.asarray(r, np.float32),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


def test_telemetry_tuples_gather_and_match_reference(world):
    """§11: each rank iterates until its own slowest slice certifies; the
    gathered (O, iters, status) equal the single-device telemetry."""
    inp, ranks, refs = world
    outs, its, sts = refs["tele"]
    _same_on_every_rank(ranks, "tele")
    o, i, s = ranks[0]["tele"]
    for a, b in zip(o, outs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    for a, b in zip(i, its):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(s, sts):
        np.testing.assert_array_equal(a, np.asarray(b))
    n_buckets = len(bucketing.plan_buckets([v.shape for v in inp["views"]],
                                           pad=True))
    assert ranks[0]["tele_gathers"] == [
        ("all_gather", dt) for _ in range(n_buckets)
        for dt in ("torch.float32", "torch.int32", "torch.int8")]


@pytest.mark.parametrize("name,prism,lr", [("muon", UPDATE, 0.05),
                                           ("shampoo", ROOTS, 1e-3)])
def test_sharded_updates_match_single_device_reference(world, name, prism,
                                                       lr):
    _, ranks, refs = world
    ref = refs[name]
    _same_on_every_rank(ranks, name)
    got, _ = ranks[0][name]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name,tol", [("muon", 2e-2), ("shampoo", 5e-2)])
def test_bf16_policy_updates_match_reference(world, name, tol):
    """Norm-level on the applied update (precond_every=2, the bf16 cache
    state included), as tests/test_sharded_precond.py holds them."""
    inp, ranks, refs = world
    params = inp["params"] if name == "muon" else inp["sq_params"]
    ref = refs[name + "16"]
    _same_on_every_rank(ranks, name + "16")
    got, _ = ranks[0][name + "16"]
    for k in params:
        d_ref, d_sh = ref[k] - params[k], got[k] - params[k]
        rel = np.linalg.norm(d_ref - d_sh) / max(np.linalg.norm(d_ref),
                                                 1e-12)
        assert rel < tol, (name, k, rel)


def test_pending_twins_share_their_active_sharding():
    """tests/test_async_precond.py:280-300: every pending twin takes its
    active buffer's sharding (the swap is a local select), the drift
    scalars and ``pending_at`` are replicated (a mesh of shape only)."""
    mesh = tmesh.make_debug_mesh(data=4, model=1)
    rng = np.random.default_rng(4)
    named = [(k, torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))))
        for k, s in (("w1", (64, 32)), ("w3", (3, 48, 32)), ("b", (64,)))]
    cfg = OptimizerConfig(name="muon", precond_async=True, precond_every=3,
                          matfn_tol=1e-2, precond_drift_slack=2.0,
                          prism=PrismConfig(**ASYNC))
    opt = make_optimizer(cfg, named, ASYNC_AXES)
    pshard = {k: sharding.replicated(mesh) for k, _ in named}
    sh = opt_state_shardings(mesh, opt, named, pshard)
    assert sh["pending_at"] == sharding.replicated(mesh)
    assert sh["count"] == sharding.replicated(mesh)
    slots = [sh[k] for k, _ in named if "ortho" in sh[k]]
    assert len(slots) == 2
    for slot in slots:
        assert slot["ortho_p"] == slot["ortho"]
        assert slot["dnorm"] == sharding.replicated(mesh)
        assert slot["rnorm"] == sharding.replicated(mesh)


def test_sharded_double_buffer_matches_single_device(world):
    """tests/test_async_precond.py:375: async Muon under the mesh (its
    refreshes sharded over the ranks) equals the reference's unsharded
    run at 2e-5, with the same refresh counters after every step."""
    _, ranks, refs = world
    ref, jcounters = refs["async"]
    _same_on_every_rank(ranks, "async")
    got, counters, dispatched = ranks[0]["async"]
    assert counters == jcounters and counters[-1]["refreshes"] >= 3
    assert all(r["async"][2] == dispatched for r in ranks)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_drift_triggered_dispatches_agree_on_every_rank(world):
    """The drift trigger under the mesh: the drift is read from state that
    is bitwise equal on every rank, so every rank dispatches at the same
    steps (else the all-gathers would hang), and the counters are the
    reference's single-device ones step for step."""
    _, ranks, refs = world
    ref, jcounters = refs["drift"]
    _same_on_every_rank(ranks, "drift")
    got, counters, dispatched = ranks[0]["drift"]
    assert counters == jcounters
    assert counters[-1]["drift_triggered"] > counters[11]["drift_triggered"]
    assert counters[-1]["clock_triggered"] == 0
    assert all(r["drift"][2] == dispatched for r in ranks)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
