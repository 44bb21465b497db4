"""The port's Muon against the reference on the CPU: the bucket plan of
gpt2-paper (shape logic only), one or two Muon updates on the SMOKE model
with the same params and grads (PRISM-5, and PRISM-3 with the same
sketches through ``JaxKey``), the padded-bucket ``n_real`` path and its
telemetry, and global-norm clipping."""
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
from repro_torch.optim import base, bucketing, make_optimizer, muon
from test_torch_prism import JaxKey

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


def _muon_both(steps, matfn_dtype, prism, keyed, **kw):
    """``steps`` Muon updates of the SMOKE params through both packages
    with the same grads; step s draws from PRNGKey(s) when ``keyed``;
    ``kw`` goes to both optimizer configs."""
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
    for s, g in enumerate(grads):
        jg = jax.tree.map(jnp.asarray, convert.params_to_jax(
            {k: torch.from_numpy(v) for k, v in g.items()}))
        jp, js = jopt.update(jg, js, jp, s, jax.random.PRNGKey(s))

    named = [(k, torch.nn.Parameter(v)) for k, v in tparams.items()]
    axes = {k: a for k, (_, a, _) in param_specs(gpt2_paper.SMOKE).items()}
    topt = make_optimizer(tcfg, named, axes)
    for s, g in enumerate(grads):
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        topt.step(key=JaxKey(jax.random.PRNGKey(s)) if keyed else None)
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
    _, tcfg = _ocfgs(precond_every=2)
    with pytest.raises(NotImplementedError, match="precond_every"):
        make_optimizer(tcfg, [], {})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(OptimizerConfig(name="adamw"), [], {})
