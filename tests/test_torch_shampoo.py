"""The port's Shampoo against the reference's ``make_shampoo`` on the CPU:
``transform_bucketed``, the gpt2-paper inverse-root bucket plan, one and
two updates of the SMOKE model with the same params and grads (Shampoo's
default PRISM-5, Fig. 5's fitted PRISM with the same sketches through
``JaxKey``, ``eigh``, the diagonal fallback); the training tests are in
``test_torch_shampoo_train.py``.

Conditioning.  The SMOKE views are [64, 256], [64, 128] and [16, 16], so
after a step or two the factor of a long side (G^T G, 256 or 128 wide) has
rank 64 and, with the 1e-6 ridge, a condition number near 1e6: its fp32
inverse root is not determined to better than ~1e-1 by either package
(``eigh`` in both is that far from the float64 answer), and the fitted
alpha, an argmin over sketched traces of such a factor, moves with the
last bits of the traces.  The warm chain, a fixed polynomial, is held on
those factors as they come.  The fitted chain and ``eigh`` are held on
full-rank factors: ``max_precond_dim=64`` sends the long sides to the
diagonal fallback, and the gradients have conditioned spectra
(``_grads(conditioned=True)``), as the reference's own Shampoo precision
tests use controlled full-rank spectra (tests/test_precision.py).

Tolerances.  The EMA factors L/R are plain fp32 products: 1e-5.  An
inverse root of the fp32 chain is held like the chain that computes it,
relative to its largest entry: 2e-4 for warm chains (the fused warm tail
against its oracle, tests/test_fused_iter.py) and 5e-3 for fitted ones
(tests/test_kernels.py); eigh 1e-5.  The grafted update moves by the
same relative amount, so the parameters are held to that bound times the
largest entry of their change over the run.  Three training steps: the
losses and parameters 1e-4 (tests/test_torch_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.configs import gpt2_paper as jgpt2
from repro.models import build
from repro.optim import bucketing as jbucketing
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import convert
from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.configs import gpt2_paper
from repro_torch.models.transformer import param_specs
from repro_torch.optim import base, bucketing, make_optimizer
from test_torch_muon import _jax_views, _port_views
from test_torch_prism import JaxKey
import torch_threads  # noqa: F401  (the worker's share of the cores)

WARM = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
            use_kernels=True)
FIG5 = dict(degree=2, iterations=5, warm_alpha_iters=0, sketch_dim=8,
            use_kernels=True)
CHAIN_TOL = {"warm": 2e-4, "fig5": 5e-3, "eigh": 1e-5}
PRISMS = {"warm": WARM, "fig5": FIG5, "eigh": WARM}


def _ocfgs(which, **kw):
    prism = PRISMS[which]
    kw = dict(kw)
    if which == "fig5":
        kw.setdefault("learning_rate", 3e-3)
    if which == "eigh":
        kw["matfn_method"] = "eigh"
    return (JOpt(name="shampoo", prism=JPrism(**prism), **kw),
            OptimizerConfig(name="shampoo", prism=PrismConfig(**prism), **kw))


# ------------------------------------------------------------ bucketing

@pytest.mark.parametrize("with_aux", [0, 2])
def test_transform_bucketed_matches_reference(with_aux):
    """One fn call per exact-shape bucket, keys by bucket index, fp32
    gathers, the results and per-slice companions scattered back."""
    rng = np.random.default_rng(0)
    shapes = [(3, 16, 16), (32, 32), (16, 16), (2, 32, 32), (24, 24)]
    mats = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def jfn(x, b, bi):
        out = x @ x + (bi + 1.0)
        if not with_aux:
            return out
        return out, jnp.sum(x, axis=(-2, -1)), jnp.full(x.shape[:1], bi)

    def tfn(x, b, bi):
        assert x.dtype == torch.float32
        out = x @ x + (bi + 1.0)
        if not with_aux:
            return out
        return out, torch.sum(x, dim=(-2, -1)), torch.full(x.shape[:1], bi)

    want = jbucketing.transform_bucketed([jnp.asarray(m) for m in mats],
                                         jfn, with_aux=with_aux)
    got = bucketing.transform_bucketed([torch.tensor(m) for m in mats], tfn,
                                       with_aux=with_aux)
    if not with_aux:
        want, got = (want,), (got,)
    assert len(got) == len(want) == (1 + with_aux)
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=1e-5, atol=1e-5)


def test_gpt2_paper_inverse_root_buckets():
    """The gpt2-paper Shampoo inverse roots: 40 attention views of
    [1024, 1024] (L and R full) and the 1024 side of 20 MLP views
    (their 4096 side takes the diagonal fallback) form one grid bucket
    [100, 1024, 1024]; the q/k/v bias views [16, 64] form the fused
    buckets [30, 16, 16] and [30, 64, 64] — as in the reference."""
    _, tcfg = _ocfgs("warm")
    maxd = tcfg.max_precond_dim
    for views in (_jax_views(jgpt2.CONFIG), _port_views(gpt2_paper.CONFIG)):
        sides = []
        for v in views:
            lead = v[:-2]
            for k in v[-2:]:
                if k <= maxd:
                    sides.append(lead + (k, k))
        plan = {(b.shape, b.size)
                for b in bucketing.plan_buckets(sides, pad=False)}
        assert plan == {((16, 16), 30), ((64, 64), 30),
                        ((1024, 1024), 100)}
    tiers = {n: bucketing.resolve_fused_tier(
        tcfg.resolved_prism, bucketing.Bucket((n, n), (), 0)).fuse
        for n in (16, 64)}
    assert tiers == {16: "on", 64: "on"}
    from repro_torch.core import newton_schulz

    assert not newton_schulz._fused_tier(tcfg.resolved_prism, (1024, 1024),
                                         coupled=True)
    assert newton_schulz._fused_tier(tcfg.resolved_prism, (64, 64),
                                     coupled=True)


# ------------------------------------------------------------ updates

def _smoke():
    cfg = jgpt2.SMOKE
    model = build(cfg)
    params = jax.tree.map(lambda p: np.asarray(p, np.float32),
                          model.init(jax.random.PRNGKey(0)))
    return model, params


def _grads(params, steps, seed=0, conditioned=False):
    """Random gradients, N(0, 0.01) entries; ``conditioned``: each matrix
    view instead has singular values in [0.05, 0.1], so that every EMA
    factor no longer than the view's short side is full rank with
    condition number at most 4 after any number of steps."""
    rng = np.random.default_rng(seed)
    specs = param_specs(gpt2_paper.SMOKE)
    out = []
    for _ in range(steps):
        g = {}
        for k, v in convert._flatten(params).items():
            shape, axes, _ = specs[k]
            if not (conditioned and base.is_matrix_param(axes, shape)):
                g[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.1
                continue
            view, meta = base.to_matrix_view(torch.zeros(shape), axes)
            m, n = view.shape[-2:]
            k_ = min(m, n)
            u, _ = np.linalg.qr(rng.standard_normal(view.shape[:-2] + (m, k_)))
            w, _ = np.linalg.qr(rng.standard_normal(view.shape[:-2] + (n, k_)))
            sv = rng.uniform(0.05, 0.1, view.shape[:-2] + (1, k_))
            gv = torch.tensor((u * sv) @ np.swapaxes(w, -1, -2),
                              dtype=torch.float32)
            g[k] = base.from_matrix_view(gv, meta).contiguous().numpy()
        out.append(g)
    return out


def _jax_run(jcfg, jmodel, params, grads, js=None, s0=0):
    jopt = jmake_optimizer(jcfg, jmodel.logical_axes())
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp) if js is None else js
    for s, g in enumerate(grads, start=s0):
        jg = jax.tree.map(jnp.asarray, convert.params_to_jax(
            {k: torch.from_numpy(v) for k, v in g.items()}))
        jp, js = jopt.update(jg, js, jp, s, jax.random.PRNGKey(s))
    return jp, js


def _port_opt(tcfg, params):
    named = [(k, torch.nn.Parameter(v)) for k, v in
             convert.params_from_jax(params, gpt2_paper.SMOKE).items()]
    axes = {k: a for k, (_, a, _) in param_specs(gpt2_paper.SMOKE).items()}
    return named, make_optimizer(tcfg, named, axes)


def _port_run(named, topt, grads, s0=0):
    for s, g in enumerate(grads, start=s0):
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        topt.step(key=JaxKey(jax.random.PRNGKey(s)))


def _hold(named, topt, jp, js, which, p0):
    """Parameters within chain tol times the largest entry of their change
    from ``p0`` (the grafted update moves like the inverse roots), L/R and
    the rest of the state 1e-5, the cached inverse roots within chain tol
    of their largest entry."""
    tol = CHAIN_TOL[which]
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    p0 = convert._flatten(jax.tree.map(np.asarray, p0))
    jstate = convert._flatten(jax.tree.map(
        lambda a: np.asarray(a, np.float32), js["leaves"]))
    for k, p in named:
        got = p.detach().numpy()
        step = np.abs(jflat[k] - p0[k]).max()
        np.testing.assert_allclose(got, jflat[k], rtol=0,
                                   atol=1e-7 + tol * step, err_msg=k)
        for name, v in topt.state[p].items():
            want = jstate[f"{k}.{name}"]
            v = v.float().numpy()
            if name.endswith(("_iters", "_status")):
                np.testing.assert_array_equal(v, want, err_msg=f"{k}.{name}")
            elif name in ("Linv", "Rinv"):
                scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
                np.testing.assert_allclose(v / scale, want / scale, rtol=0,
                                           atol=tol, err_msg=f"{k}.{name}")
            else:
                np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{k}.{name}")
    assert topt.count == int(js["count"])


FULL_RANK = {"warm": {}, "fig5": dict(max_precond_dim=64),
             "eigh": dict(max_precond_dim=64)}


@pytest.mark.parametrize("which", ["warm", "fig5", "eigh"])
@pytest.mark.parametrize("steps", [1, 2])
def test_shampoo_update_matches_reference(which, steps):
    jmodel, params = _smoke()
    grads = _grads(params, steps, conditioned=which != "warm")
    jcfg, tcfg = _ocfgs(which, **FULL_RANK[which])
    jp, js = _jax_run(jcfg, jmodel, params, grads)
    named, topt = _port_opt(tcfg, params)
    _port_run(named, topt, grads)
    _hold(named, topt, jp, js, which, params)
    kinds = {frozenset(topt.state[p]) for _, p in named}
    assert frozenset({"mom", "L", "Linv", "R", "Rinv"}) in kinds
    assert frozenset({"mom", "nu"}) in kinds


@pytest.mark.parametrize("which", ["warm", "fig5", "eigh"])
def test_diagonal_fallback_matches_reference(which):
    """max_precond_dim=16: every side longer than 16 takes the diagonal
    (AdaGrad) preconditioner, L and R, beside the full [16, 16] bias
    factors."""
    jmodel, params = _smoke()
    grads = _grads(params, 2, seed=1, conditioned=True)
    jcfg, tcfg = _ocfgs(which, max_precond_dim=16)
    jp, js = _jax_run(jcfg, jmodel, params, grads)
    named, topt = _port_opt(tcfg, params)
    _port_run(named, topt, grads)
    _hold(named, topt, jp, js, which, params)
    assert any("diagR" in topt.state[p] for _, p in named)
    assert any("diagL" in topt.state[p] for _, p in named)


def test_carrying_an_unported_state_key_raises():
    """The async refresh plane's pending twins, drift proxy and
    ``pending_at`` now carry across (in the port's dtypes); a key neither
    optimizer carries still raises."""
    jmodel, params = _smoke()
    jcfg, tcfg = _ocfgs("warm", precond_async=True, precond_every=2)
    js = jmake_optimizer(jcfg, jmodel.logical_axes()).init(
        jax.tree.map(jnp.asarray, params))
    js = dict(js, pending_at=jnp.asarray(5, jnp.int32))
    named, topt = _port_opt(tcfg, params)
    convert.shampoo_state_from_jax(topt, named, jax.tree.map(np.asarray, js))
    assert topt.pending_at == topt.pending_host == 5
    jstate = convert._flatten(jax.tree.map(np.asarray, js["leaves"]))
    carried = set()
    for k, p in named:
        for name, v in topt.state[p].items():
            want = jstate[f"{k}.{name}"]
            assert v.dtype == getattr(torch, str(want.dtype)), (k, name)
            carried.add(name)
    assert {"Linv_p", "Rinv_p", "dnorm", "rnorm"} <= carried
    leaves = jax.tree.map(np.asarray, js["leaves"])
    leaves["layers"]["attn"]["wq"]["bogus"] = np.zeros(())
    with pytest.raises(KeyError, match="bogus"):
        convert.shampoo_state_from_jax(topt, named,
                                       dict(js, leaves=leaves))


def test_unported_options_raise():
    """matfn_method="newton", bucketed=False, p_root != 2 and the async
    refresh plane now build (tests/test_torch_shampoo_roots.py and
    tests/test_torch_async_precond.py hold them against the
    reference)."""
    from repro_torch.optim.shampoo import Shampoo

    named = [("w", torch.nn.Parameter(torch.zeros(2)))]
    for kw in (dict(matfn_method="newton"), dict(bucketed=False)):
        _, tcfg = _ocfgs("warm", **kw)
        assert isinstance(make_optimizer(tcfg, named, {"w": ("embed",)}),
                          Shampoo)
    _, tcfg = _ocfgs("warm")
    assert Shampoo(named, tcfg, {"w": ("embed",)}, p_root=4).p_root == 4
    _, tcfg = _ocfgs("warm", precond_async=True, precond_every=2)
    opt = make_optimizer(tcfg, named, {"w": ("embed",)})
    assert opt.pending_at == base.NO_PENDING


def test_polar_express_matches_reference():
    """matfn_method="polar_express": the coupled fixed schedule on full-rank
    factors, two steps, held like the warm chain."""
    jmodel, params = _smoke()
    grads = _grads(params, 2, seed=4, conditioned=True)
    jcfg, tcfg = _ocfgs("warm", matfn_method="polar_express",
                        max_precond_dim=64)
    jp, js = _jax_run(jcfg, jmodel, params, grads)
    named, topt = _port_opt(tcfg, params)
    _port_run(named, topt, grads)
    _hold(named, topt, jp, js, "warm", params)


def test_matfn_tol_telemetry_matches_reference():
    """An adaptive tol on the fitted chain, precondition_every=2: every
    full-matrix side carries "Linv_iters"/"Rinv_iters" (int32) and
    "Linv_status"/"Rinv_status" (int8), equal to the reference's after
    the refresh steps 0 and 2 and carried untouched through step 1."""
    jmodel, params = _smoke()
    grads = _grads(params, 3, seed=5, conditioned=True)
    jcfg, tcfg = _ocfgs("fig5", matfn_tol=0.05, precondition_every=2,
                        **FULL_RANK["fig5"])
    assert tcfg.matfn_telemetry
    named, topt = _port_opt(tcfg, params)
    jp, js, seen = params, None, []
    for s in range(3):
        jp, js = _jax_run(jcfg, jmodel, jax.tree.map(np.asarray, jp),
                          grads[s:s + 1], js=js, s0=s)
        _port_run(named, topt, grads[s:s + 1], s0=s)
        _hold(named, topt, jp, js, "fig5", params)
        seen.append({k: topt.state[p]["Linv_iters"].clone()
                     for k, p in named if "Linv_iters" in topt.state[p]})
    assert seen[0] and all(int(v.min()) >= 1 for v in seen[0].values())
    assert all(torch.equal(seen[0][k], seen[1][k]) for k in seen[0])
