"""The port's Muon against the reference on the CPU: the bucket plan of
gpt2-paper (shape logic only), one or two Muon updates on the SMOKE model
with the same params and grads (PRISM-5, and PRISM-3 with the same
sketches through ``JaxKey``), the padded-bucket ``n_real`` path and its
telemetry, global-norm clipping, the ``precond_every`` staleness cache
(its skip steps make no matrix-function call), the ``matfn_tol``
telemetry state, the svd and polar_express methods, AdamW and the
``skip_nonfinite`` guard."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.configs import gpt2_paper as jgpt2
from repro.models import build
from repro.optim import base as jbase
from repro.optim import bucketing as jbucketing
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import convert
from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.configs import gpt2_paper
from repro_torch.core.rng import Key
from repro_torch.models.transformer import param_specs
from repro_torch.optim import AdamW, base, bucketing, make_optimizer, muon
from test_torch_prism import JaxKey
import torch_threads  # noqa: F401  (the worker's share of the cores)

PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)
PRISM3 = dict(degree=1, iterations=5, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)


def _ocfgs(prism=PRISM5, **kw):
    return (JOpt(name="muon", prism=JPrism(**prism), **kw),
            OptimizerConfig(name="muon", prism=PrismConfig(**prism), **kw))


def _jax_views(cfg):
    model = build(cfg)
    shapes = model.param_shapes()
    axes = model.logical_axes()
    is_axes = lambda t: isinstance(t, tuple)  # noqa: E731
    flat_s = jax.tree.leaves(shapes)
    flat_a = jax.tree.leaves(axes, is_leaf=is_axes)
    views = []
    for s, a in zip(flat_s, flat_a):
        if jbase.is_matrix_param(a, s.shape):
            v = jax.eval_shape(lambda x, _a=a: jbase.to_matrix_view(x, _a)[0],
                               s)
            views.append(tuple(v.shape))
    return views


def _port_views(cfg):
    views = []
    for shape, axes, _ in param_specs(cfg).values():
        if base.is_matrix_param(axes, shape):
            v, _ = base.to_matrix_view(torch.empty(shape, device="meta"),
                                       axes)
            views.append(tuple(v.shape))
    return views


def test_gpt2_paper_bucket_plan_matches_reference():
    jviews, tviews = _jax_views(jgpt2.CONFIG), _port_views(gpt2_paper.CONFIG)
    assert sorted(jviews) == sorted(tviews)
    jcfg, tcfg = _ocfgs()
    jplan = {(b.shape, b.size) for b in jbucketing.plan_buckets(jviews)}
    tplan = {(b.shape, b.size) for b in bucketing.plan_buckets(tviews)}
    assert jplan == tplan == {((16, 64), 30), ((1024, 1024), 40),
                              ((1024, 4096), 20)}
    tiers = {s: bucketing.resolve_tier(tcfg, s) for s, _ in tplan}
    assert tiers == {s: jbucketing.resolve_tier(jcfg, s) for s, _ in jplan}
    assert tiers == {(16, 64): "fused", (1024, 1024): "grid",
                     (1024, 4096): "grid"}


def _smoke_params():
    cfg = jgpt2.SMOKE
    model = build(cfg)
    params = jax.tree.map(lambda p: np.asarray(p, np.float32),
                          model.init(jax.random.PRNGKey(0)))
    return cfg, model, params


#: the kernel wrappers of ``kernels/ops.py`` the matrix functions call; on
#: the CPU each runs its plain version, counted here by wrapping it
OPS = ("matmul_add", "gram", "warm_tail", "sketch_traces",
       "residual_chain", "apply_g")


@contextlib.contextmanager
def count_ops():
    """Counts the calls of each ``OPS`` wrapper inside the block."""
    from repro_torch.kernels import ops

    counts = dict.fromkeys(OPS, 0)
    real = {n: getattr(ops, n) for n in OPS}

    def counted(name):
        def call(*a, **k):
            counts[name] += 1
            return real[name](*a, **k)
        return call

    for n in OPS:
        setattr(ops, n, counted(n))
    try:
        yield counts
    finally:
        for n, f in real.items():
            setattr(ops, n, f)


def _muon_both(steps, matfn_dtype, prism, keyed, refresh=None, each=None,
               **kw):
    """``steps`` Muon updates of the SMOKE params through both packages
    with the same grads; step s draws from PRNGKey(s) when ``keyed`` and
    takes ``refresh[s]`` as its static refresh override when given;
    ``each(s, jp, js, named, topt, calls)`` runs after both packages took
    step s (``calls``: the port step's ``OPS`` calls); ``kw`` goes to both
    optimizer configs."""
    cfg, jmodel, params = _smoke_params()
    tparams = convert.params_from_jax(params, gpt2_paper.SMOKE)
    rng = np.random.default_rng(0)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
              for k, v in convert._flatten(params).items()}
             for _ in range(steps)]
    jcfg, tcfg = _ocfgs(prism, matfn_dtype=matfn_dtype, **kw)

    jopt = jmake_optimizer(jcfg, jmodel.logical_axes())
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    named = [(k, torch.nn.Parameter(v)) for k, v in tparams.items()]
    axes = {k: a for k, (_, a, _) in param_specs(gpt2_paper.SMOKE).items()}
    topt = make_optimizer(tcfg, named, axes)
    for s, g in enumerate(grads):
        r = None if refresh is None else refresh[s]
        jg = jax.tree.map(jnp.asarray, convert.params_to_jax(
            {k: torch.from_numpy(v) for k, v in g.items()}))
        jp, js = jopt.update(jg, js, jp, s, jax.random.PRNGKey(s),
                             refresh=r)
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        with count_ops() as calls:
            topt.step(key=JaxKey(jax.random.PRNGKey(s)) if keyed else None,
                      refresh=r)
        if each is not None:
            each(s, jp, js, named, topt, calls)
    return tcfg, jp, js, named, topt


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("matfn_dtype", ["float32", "bfloat16"])
def test_muon_update_matches_reference(steps, matfn_dtype):
    tcfg, jp, js, named, topt = _muon_both(steps, matfn_dtype, PRISM5,
                                           keyed=False)

    # fp32: the 1e-5 bound.  bf16 orthogonalization: the update O * scale
    # (|O| <= 1, scale <= 2) is bf16, and so is lr * update; fp32 sums in
    # another order may flip one rounding of each, so the gap is bounded
    # by lr * 2 * 2 bf16 half-ulps (2^-8 each) = lr * 2 * 2^-7
    lr = tcfg.learning_rate
    tol = 1e-5 if matfn_dtype == "float32" else lr * 2 * 2.0 ** -7
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    jstate = convert._flatten(jax.tree.map(np.asarray, js["leaves"]))
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=tol,
                                   atol=tol, err_msg=k)
        st = topt.state[p]
        for name, v in st.items():
            np.testing.assert_allclose(v.numpy(), jstate[f"{k}.{name}"],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    assert topt.count == int(js["count"]) == steps


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("matfn_dtype", ["float32", "bfloat16"])
def test_prism3_muon_update_matches_reference(steps, matfn_dtype):
    """PRISM-3 (two fitted iterations) with the same per-step sketch keys:
    the fitted alphas, hence the updates, agree.  Bounds as for PRISM-5
    (the fit's alphas agree to ~1e-6 in fp32)."""
    tcfg, jp, js, named, topt = _muon_both(steps, matfn_dtype, PRISM3,
                                           keyed=True)
    lr = tcfg.learning_rate
    tol = 1e-5 if matfn_dtype == "float32" else lr * 2 * 2.0 ** -7
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=tol,
                                   atol=tol, err_msg=k)
    assert topt.count == int(js["count"]) == steps


def test_prism3_per_leaf_muon_update_matches_reference():
    """``bucketed=False``: one polar chain a matrix leaf, each drawing its
    sketch from ``fold_in(key, i)`` with ``i`` the leaf's index in the
    reference's (sorted-key) leaf order; the fitted alphas, hence the
    updates, agree at the fp32 bound."""
    tcfg, jp, js, named, topt = _muon_both(1, "float32", PRISM3, keyed=True,
                                           bucketed=False)
    assert not tcfg.bucketed
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_leaf_order_is_the_reference_flatten_order():
    _, _, params = _smoke_params()
    jnames = [".".join(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    names = list(param_specs(gpt2_paper.SMOKE))
    assert names != jnames
    idx = muon.leaf_order(names)
    assert [names[idx.index(r)] for r in range(len(names))] == jnames


def test_prism3_update_reads_the_key():
    """The fitted iterations draw from the step's key: the same key gives
    the same update bit for bit, another key a nearby one."""
    _, _, params = _smoke_params()
    tparams = convert.params_from_jax(params, gpt2_paper.SMOKE)
    axes = {k: ax for k, (_, ax, _) in param_specs(gpt2_paper.SMOKE).items()}
    outs = []
    for seed in (1, 1, 2):
        named = [(k, torch.nn.Parameter(v.clone()))
                 for k, v in tparams.items()]
        opt = make_optimizer(_ocfgs(PRISM3)[1], named, axes)
        for _, p in named:
            p.grad = 0.01 + 0.1 * p.detach()
        opt.step(key=Key(seed))
        outs.append({k: p.detach().clone() for k, p in named})
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)
    diff = max(float((outs[0][k] - outs[2][k]).abs().max()) for k in outs[0])
    assert 0 < diff < 1e-2


@pytest.mark.parametrize("with_iters", [False, True])
def test_padded_bucket_n_real_matches_reference(with_iters):
    """bucket_pad merges (64, 24) into the (64, 30) bucket; the fitted
    chain gets each slice's real Gram extent (n_real) and matches the
    reference's polar_bucketed, telemetry included."""
    rng = np.random.default_rng(2)
    shapes = [(2, 64, 30), (64, 24), (3, 40, 40)]
    views = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(bucket_pad=True, bucket_pad_slack=0.3)
    jcfg, tcfg = _ocfgs(PRISM3, **kw)
    plan = bucketing.plan_buckets(shapes, pad=True, pad_slack=0.3)
    assert [(b.shape, b.padded) for b in plan] == [((40, 40), False),
                                                  ((64, 30), True)]
    assert bucketing._gram_real_dims(plan[1], "cpu").tolist() == [30, 30, 24]
    key = jax.random.PRNGKey(9)
    want = jbucketing.polar_bucketed([jnp.asarray(v) for v in views], jcfg,
                                     key, with_iters=with_iters)
    got = bucketing.polar_bucketed([torch.from_numpy(v) for v in views],
                                   tcfg, JaxKey(key), with_iters=with_iters)
    if with_iters:
        (want, jits, jsts), (got, its, sts) = want, got
        for a, b in zip(its, jits):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(sts, jsts):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert [tuple(a.shape) for a in its] == [(2,), (), (3,)]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=5e-3)


@pytest.mark.parametrize("case", ["under", "over", "nonfinite", "zero"])
def test_clip_by_global_norm_matches_reference(case):
    rng = np.random.default_rng(1)
    gs = [rng.standard_normal(s).astype(np.float32)
          for s in [(4, 8), (16,), (3, 5, 2)]]
    if case == "under":
        gs = [g * 1e-3 for g in gs]
    if case == "nonfinite":
        gs[1][3] = np.inf
    if case == "zero":
        gs = [np.zeros_like(g) for g in gs]
    jg, jn = jbase.clip_by_global_norm([jnp.asarray(g) for g in gs], 1.0)
    tg, tn = base.clip_by_global_norm([torch.from_numpy(g) for g in gs], 1.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_unported_options_raise():
    """precond_every > 1, adamw, the lowrank tier, the async refresh plane
    and ``muon_local_reshard`` build; the async plane on sharded
    parameters builds too, its cache and twin held as their
    ``precond_cache_sharding`` block (the rows over data)."""
    named = [("w", torch.nn.Parameter(torch.zeros(32, 16)))]
    axes = {"w": ("embed", "mlp")}
    _, tcfg = _ocfgs(precond_every=2)
    assert isinstance(make_optimizer(tcfg, named, axes), muon.Muon)
    assert isinstance(make_optimizer(OptimizerConfig(name="adamw"), named,
                                     axes), AdamW)
    _, tcfg = _ocfgs(lowrank_rank=4)
    assert isinstance(make_optimizer(tcfg, named, axes), muon.Muon)
    _, tcfg = _ocfgs(precond_async=True, precond_every=2)
    opt = make_optimizer(tcfg, named, axes)
    assert isinstance(opt, muon.Muon) and opt.pending_at == base.NO_PENDING
    _, tcfg = _ocfgs(muon_local_reshard=True)
    assert isinstance(make_optimizer(tcfg, named, axes), muon.Muon)
    from repro_torch.launch import mesh, sharding

    rows = {"w": sharding.named(mesh.make_debug_mesh(data=2, model=1),
                                ("data", None))}
    _, tcfg = _ocfgs(precond_async=True, precond_every=2)
    opt = make_optimizer(tcfg, named, axes, rows)
    st = opt.state[named[0][1]]
    assert tuple(st["ortho"].shape) == (32, 16)  # of the whole [64, 16]
    assert opt.blocks.layouts[0]["ortho_p"].spec == ("data", None)


# ------------------------------------------------- staleness cache (§8)

def _hold_all(tcfg, jp, js, named, topt, matfn_dtype, updates=1):
    """Parameters at the file's update bound, every state entry at 1e-5
    (``ortho``, a bf16 polar in a bf16 cache, at the update bound over
    lr: two bf16 half-ulps), telemetry exactly, and the count.  In bf16
    the parameters' bound is that of one update times ``updates``, the
    updates applied so far: a stale step applies the same cached polar
    again, so a one-ulp difference in the cache adds to the parameters'
    gap at every step that serves it."""
    lr = tcfg.learning_rate
    ortho_tol = 1e-5 if matfn_dtype == "float32" else 2 * 2.0 ** -7
    tol = 1e-5 if matfn_dtype == "float32" else lr * ortho_tol * updates
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    jstate = convert._flatten(jax.tree.map(np.asarray, js["leaves"]))
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=tol,
                                   atol=tol, err_msg=k)
        st = topt.state[p]
        assert set(st) == {n.split(".")[-1] for n in jstate
                           if n.rsplit(".", 1)[0] == k}, k
        for name, v in st.items():
            want = jstate[f"{k}.{name}"]
            assert v.dtype == getattr(torch, str(want.dtype)), (k, name)
            if name in ("iters", "status"):
                np.testing.assert_array_equal(v.numpy(), want,
                                              err_msg=f"{k}.{name}")
                continue
            t = ortho_tol if name == "ortho" else 1e-5
            np.testing.assert_allclose(v.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=t, atol=t, err_msg=f"{k}.{name}")
    assert int(topt.count) == int(js["count"])


@pytest.mark.parametrize("matfn_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prism", ["prism5", "prism3"])
def test_precond_every_3_matches_reference(matfn_dtype, prism):
    """Four steps with precond_every=3: steps 0 and 3 refresh the cache in
    matfn_dtype (cache_dtype "auto"), steps 1 and 2 apply it and call no
    matrix function at all; parameters and every state entry, "ortho"
    included, agree after every step."""
    calls = []

    def each(s, jp, js, named, topt, c):
        calls.append(sum(c.values()))
        _hold_all(tcfg, jp, js, named, topt, matfn_dtype, updates=s + 1)

    tcfg = _ocfgs(precond_every=3, matfn_dtype=matfn_dtype)[1]
    _muon_both(4, matfn_dtype,
                          PRISM5 if prism == "prism5" else PRISM3,
                          keyed=prism == "prism3", each=each,
                          precond_every=3)
    assert tcfg.cache_dtype == matfn_dtype
    assert calls[0] > 0 and calls[3] == calls[0]
    assert calls[1] == calls[2] == 0


def test_static_refresh_override_matches_reference():
    """refresh=True/False forces the choice against the count's schedule
    (the reference's static ``refresh=``): step 1 refreshes although
    1 % 2 != 0, step 2 serves the cache although 2 % 2 == 0."""
    calls = []

    def each(s, jp, js, named, topt, c):
        calls.append(sum(c.values()))
        _hold_all(tcfg, jp, js, named, topt, "float32")

    tcfg = _ocfgs(precond_every=2)[1]
    _muon_both(3, "float32", PRISM5, keyed=False, each=each,
               refresh=[True, True, False], precond_every=2)
    assert calls[0] == calls[1] > 0 and calls[2] == 0


def test_matfn_tol_telemetry_matches_reference():
    """An adaptive tol on PRISM-3 with precond_every=2: every matrix leaf
    carries the realized iteration counts "iters" (int32) and guardian
    codes "status" (int8) of its view's slices, equal to the reference's
    after the refresh steps 0 and 2 and the stale step 1, which carries
    step 0's untouched."""
    precond_every = 2
    seen = []

    def each(s, jp, js, named, topt, c):
        _hold_all(tcfg, jp, js, named, topt, "float32")
        seen.append({k: topt.state[p]["iters"].clone() for k, p in named
                     if "iters" in topt.state[p]})

    kw = dict(matfn_tol=0.05, precond_every=precond_every)
    tcfg = _ocfgs(PRISM3, **kw)[1]
    assert tcfg.matfn_telemetry
    _muon_both(3, "float32", PRISM3, keyed=True, each=each, **kw)
    assert seen[0] and all(int(v.min()) >= 1 for v in seen[0].values())
    assert all(torch.equal(seen[0][k], seen[1][k]) for k in seen[0])


@pytest.mark.parametrize("method", ["svd", "polar_express"])
@pytest.mark.parametrize("bucketed", [True, False])
def test_baseline_methods_match_reference(method, bucketed):
    """matfn_method svd (fp32 buckets, never padded) and polar_express,
    bucketed and per leaf, two steps at the fp32 bound."""
    tcfg, jp, js, named, topt = _muon_both(
        2, "float32", PRISM5, keyed=False, matfn_method=method,
        bucketed=bucketed, bucket_pad=True)
    _hold_all(tcfg, jp, js, named, topt, "float32")


def test_with_iters_needs_an_ns_method():
    _, tcfg = _ocfgs(matfn_method="svd")
    with pytest.raises(ValueError, match="NS-family"):
        bucketing.polar_bucketed([torch.ones(4, 4)], tcfg, with_iters=True)


# -------------------------------------------------------------- AdamW

def test_adamw_matches_reference():
    """Three AdamW steps of the SMOKE params with the same grads: the
    parameters and both moments at 1e-5."""
    from repro.optim.adamw import make_adamw

    _, _, params = _smoke_params()
    tparams = convert.params_from_jax(params, gpt2_paper.SMOKE)
    rng = np.random.default_rng(3)
    cfg = dict(name="adamw", learning_rate=1e-2, weight_decay=0.1)
    jopt = make_adamw(JOpt(**cfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    named = [(k, torch.nn.Parameter(v)) for k, v in tparams.items()]
    topt = make_optimizer(OptimizerConfig(**cfg), named, {})
    for s in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in tparams.items()}
        jp, js = jopt.update(jax.tree.map(jnp.asarray, convert.params_to_jax(
            {k: torch.from_numpy(v) for k, v in g.items()})), js, jp, s, None)
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        topt.step()
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    for name in ("mom", "nu"):
        jst = convert._flatten(jax.tree.map(np.asarray, js[name]))
        for k, p in named:
            np.testing.assert_allclose(topt.state[p][name].numpy(), jst[k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert topt.count == int(js["count"]) == 3


# --------------------------------------------------- skip-step guard (§15)

def _tiny_both(key, use_kernels=False, tol=1e-2):
    """The reference's ``tests/test_guardian.py::_tiny_opt`` in both
    packages: Muon with an adaptive tol and skip_nonfinite."""
    from repro.optim import make_optimizer as jmake

    kw = dict(name="muon", matfn_tol=tol, skip_nonfinite=True)
    pk = dict(degree=2, iterations=4, warm_alpha_iters=1, sketch_dim=8,
              tol=tol, use_kernels=use_kernels)
    params = {"w": jax.random.normal(jax.random.PRNGKey(7), (32, 16)),
              "b": jnp.ones((16,))}
    axes = {"w": ("embed", "mlp"), "b": ("mlp",)}
    jopt = jmake(JOpt(prism=JPrism(**pk), **kw), axes)
    named = [(k, torch.nn.Parameter(torch.from_numpy(np.array(v))))
             for k, v in params.items()]
    topt = make_optimizer(OptimizerConfig(prism=PrismConfig(**pk), **kw),
                          named, axes)
    return jopt, params, named, topt


def _snapshot(named, topt):
    return ({k: p.detach().clone() for k, p in named},
            {k: {n: v.clone() for n, v in topt.state[p].items()}
             for k, p in named}, topt.count.clone())


def _assert_same(a, b):
    (pa, sa, ca), (pb, sb, cb) = a, b
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
        for n in sa[k]:
            assert torch.equal(sa[k][n], sb[k][n]), (k, n)
    assert torch.equal(ca, cb)


@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_skip_step_rolls_back_bitwise(bad):
    """The reference's test_skip_step_rolls_back_bitwise (a NaN gradient
    after a good step) and test_skip_step_catches_inf_gradient (an inf
    one at the first step), on the port: parameters and every state
    buffer bitwise unchanged, bad_steps 1, count unchanged; the next good
    step applies normally and agrees with the reference's."""
    key = jax.random.PRNGKey(0)
    jopt, params, named, topt = _tiny_both(key)
    assert isinstance(topt, base.SkipNonfinite)
    js, jp = jopt.init(params), params
    good = {k: np.ones(v.shape, np.float32) for k, v in params.items()}
    poison = {k: np.full(v.shape, np.nan if bad == "nan" else np.inf,
                         np.float32) for k, v in params.items()}
    grads = [good, poison, good] if bad == "nan" else [poison, good]
    for s, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, s, key)
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        before = _snapshot(named, topt)
        topt.step(key=JaxKey(key))
        if g is poison:
            _assert_same(before, _snapshot(named, topt))
            assert int(topt.bad_steps) == int(js["bad_steps"]) == 1
        assert int(topt.count) == int(js["count"])
        for k, p in named:
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert int(topt.bad_steps) == 1
    assert all(torch.isfinite(v.float()).all()
               for st in topt.state.values() for v in st.values())


def test_skip_step_makes_the_same_calls():
    """The guard adds no matrix-function call: a poisoned step runs the
    same kernel-wrapper calls as a good one (a fixed iteration count: an
    adaptive tol stops a NaN slice at once, by design)."""
    key = jax.random.PRNGKey(0)
    _, params, named, topt = _tiny_both(key, use_kernels=True, tol=None)
    calls = []
    for fill in (1.0, np.nan):
        for k, p in named:
            p.grad = torch.full(p.shape, fill)
        with count_ops() as c:
            topt.step(key=JaxKey(key))
        calls.append(dict(c))
    assert calls[0] == calls[1] and sum(calls[0].values()) > 0
