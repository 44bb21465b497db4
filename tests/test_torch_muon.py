"""The port's Muon against the reference on the CPU: the bucket plan of
gpt2-paper (shape logic only), one or two Muon updates on the SMOKE model
in fp32 with the same params and grads, and global-norm clipping."""
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
from repro_torch.models.transformer import param_specs
from repro_torch.optim import base, bucketing, make_optimizer

PRISM5 = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)


def _ocfgs(**kw):
    return (JOpt(name="muon", prism=JPrism(**PRISM5), **kw),
            OptimizerConfig(name="muon", prism=PrismConfig(**PRISM5), **kw))


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


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("matfn_dtype", ["float32", "bfloat16"])
def test_muon_update_matches_reference(steps, matfn_dtype):
    cfg, jmodel, params = _smoke_params()
    tparams = convert.params_from_jax(params, gpt2_paper.SMOKE)
    rng = np.random.default_rng(0)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
              for k, v in convert._flatten(params).items()}
             for _ in range(steps)]
    jcfg, tcfg = _ocfgs(matfn_dtype=matfn_dtype)

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
    for g in grads:
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        topt.step()

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
        make_optimizer(OptimizerConfig(name="shampoo"), [], {})
