"""The port's lowrank tier (DESIGN.md §14: ``core/lowrank.py``, the
planner in ``optim/bucketing.py``, the cost models in ``kernels/ops.py``
and Muon's vocab routing) against the reference on the CPU, with the same
numpy inputs and sketches (``JaxKey``).

Tolerances: the rangefinder and the lowrank polar run the same fp32
products and polar chains in both packages, and their outputs (partial
isometries: singular values 1) are held at 1e-5 absolute, on inputs whose
rank is at least l — a surplus sketch direction is rounding noise that
the chain amplifies to unit size, different in each package; against
the SVD top-k oracle at the reference's 1e-4 (tests/test_lowrank.py); a
Muon update at tests/test_torch_muon.py's 1e-5.  The planner and the cost
models are equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import PrismConfig as JPrism
from repro.configs import gpt2_paper as jgpt2
from repro.core import lowrank as jlowrank
from repro.kernels import ops as jops
from repro.models import build
from repro.optim import base as jbase
from repro.optim import bucketing as jbucketing
from repro_torch import convert
from repro_torch.config import OptimizerConfig, PrismConfig
from repro_torch.configs import gpt2_paper
from repro_torch.core import lowrank
from repro_torch.kernels import ops
from repro_torch.models.transformer import param_specs
from repro_torch.optim import base, bucketing
from test_torch_muon import _muon_both, count_ops
from test_torch_prism import JaxKey

# the reference tests' chain (tests/test_lowrank.py), cut to 2 warm and 2
# fitted iterations and without its adaptive tol for parity: unconverged,
# so that a sketch drawn under another key moves the result; and the
# tol'd chain itself for the oracle checks
CHAIN = dict(degree=2, iterations=4, warm_alpha_iters=2, sketch_dim=8)
ORACLE = dict(CHAIN, iterations=30, tol=1e-6)


def _rank_l(seed, lead, m, n, l):
    """rank l with a well-separated spectrum: every sketched direction is
    genuine (tests/test_lowrank.py's ``_rank_l_matrix``)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(tuple(lead) + (m, l)) @ \
        rng.standard_normal(tuple(lead) + (l, n))
    return a.astype(np.float32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_rangefinder_matches_reference():
    """Parity on a rank-8 input with l = 8; then, as the reference's own
    test, an orthonormal Q that captures a rank-4 input's range."""
    key = jax.random.PRNGKey(1)
    a = _rank_l(0, (), 96, 24, 8)
    want = jlowrank.rangefinder(jnp.asarray(a), 8, key, cfg=JPrism(**CHAIN))
    got = lowrank.rangefinder(torch.tensor(a), 8, JaxKey(key),
                              cfg=PrismConfig(**CHAIN))
    _close(got, want)
    a = _rank_l(0, (), 96, 24, 4)
    q = lowrank.rangefinder(torch.tensor(a), 8, JaxKey(key),
                            cfg=PrismConfig(**ORACLE))
    torch.testing.assert_close(q.T @ q, torch.eye(8), rtol=0, atol=1e-4)
    torch.testing.assert_close(q @ (q.T @ torch.tensor(a)), torch.tensor(a),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("lead,m,n", [((), 96, 24), ((), 24, 96),
                                      ((3,), 24, 96)],
                         ids=["tall", "wide", "batched"])
def test_polar_lowrank_matches_reference(lead, m, n):
    """Tall, wide (through the transpose) and batched views, with the
    subspace chain's iteration telemetry; and the top-l SVD oracle."""
    a = _rank_l(2, lead, m, n, 8)
    key = jax.random.PRNGKey(3)
    want, wit = jlowrank.polar_lowrank(jnp.asarray(a), 4, 4,
                                       cfg=JPrism(**CHAIN), key=key,
                                       return_iters=True)
    got, it = lowrank.polar_lowrank(torch.tensor(a), 4, 4,
                                    cfg=PrismConfig(**CHAIN),
                                    key=JaxKey(key), return_iters=True)
    _close(got, want)
    np.testing.assert_array_equal(it.numpy(), np.asarray(wit))
    assert tuple(got.shape) == tuple(lead) + (m, n)
    o = lowrank.polar_lowrank(torch.tensor(a), 4, 4,
                              cfg=PrismConfig(**ORACLE), key=JaxKey(key))
    torch.testing.assert_close(o, lowrank.svd_topk(torch.tensor(a), 8),
                               rtol=0, atol=1e-4)


def test_polar_bucketed_lowrank_matches_reference():
    """The bucketed engine routes the [96, 24] bucket (aspect 4) through
    the lowrank tier under its bucket key (``key.fold_in(1)``: it sorts
    after the [24, 24] bucket, which keeps the cubic chain), with the
    subspace chain's telemetry."""
    kw = dict(lowrank_rank=4, lowrank_oversample=4, lowrank_max_dim=64)
    jcfg = JOpt(name="muon", prism=JPrism(**CHAIN), **kw)
    tcfg = OptimizerConfig(name="muon", prism=PrismConfig(**CHAIN), **kw)
    views = [_rank_l(5, (), 96, 24, 8), _rank_l(6, (2,), 24, 24, 24)]
    key = jax.random.PRNGKey(7)
    want = jbucketing.polar_bucketed([jnp.asarray(v) for v in views], jcfg,
                                     key, with_iters=True)
    got = bucketing.polar_bucketed([torch.tensor(v) for v in views], tcfg,
                                   JaxKey(key), with_iters=True)
    assert [b.shape for b in bucketing.plan_buckets(
        [v.shape for v in views])] == [(24, 24), (96, 24)]
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _views(jax_side: bool, cfg):
    """Matrix view shapes of every Muon leaf of ``cfg`` with the vocab
    tables claimed (``allow_embed``), in either package."""
    if jax_side:
        model = build(cfg)
        flat_s = jax.tree.leaves(model.param_shapes())
        flat_a = jax.tree.leaves(model.logical_axes(),
                                 is_leaf=lambda t: isinstance(t, tuple))
        return sorted(
            tuple(jax.eval_shape(lambda x, _a=a: jbase.to_matrix_view(
                x, _a)[0], s).shape)
            for s, a in zip(flat_s, flat_a)
            if jbase.is_matrix_param(a, s.shape, True))
    return sorted(
        tuple(base.to_matrix_view(torch.empty(shape, device="meta"),
                                  axes)[0].shape)
        for shape, axes, _ in param_specs(cfg).values()
        if base.is_matrix_param(axes, shape, allow_embed=True))


@pytest.mark.parametrize("aspect", [4.0, 8.0])
def test_gpt2_paper_tiers_match_reference(aspect):
    """The tier of every gpt2-paper view (vocab tables included) with
    rank 128 + 8 and max_dim 4096: at aspect 8 only the vocab tables take
    the lowrank tier; at 4 the [4096, 1024] MLP views join them."""
    kw = dict(lowrank_rank=128, lowrank_oversample=8, lowrank_max_dim=4096,
              lowrank_aspect=aspect)
    prism = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
                 use_kernels=True)
    jcfg = JOpt(name="muon", prism=JPrism(**prism), **kw)
    tcfg = OptimizerConfig(name="muon", prism=PrismConfig(**prism), **kw)
    views = _views(False, gpt2_paper.CONFIG)
    assert views == _views(True, jgpt2.CONFIG)
    tiers = {}
    for v in views:
        mshape = v[-2:]
        assert bucketing.resolve_lowrank_tier(tcfg, mshape) == \
            jbucketing.resolve_lowrank_tier(jcfg, mshape)
        tiers[mshape] = bucketing.resolve_tier(tcfg, mshape)
        assert tiers[mshape] == jbucketing.resolve_tier(jcfg, mshape)
    assert bucketing.TIER_CODES == jbucketing.TIER_CODES
    want = {(1024, 50272): "lowrank", (1024, 1024): "grid",
            (1024, 4096): "lowrank" if aspect == 4.0 else "grid",
            (16, 64): "fused"}
    assert tiers == want


SHAPES = [(1024, 50272), (50272, 1024), (4096, 1024), (1024, 1024),
          (64, 256), (96, 24), (7, 5)]


@pytest.mark.parametrize("mshape", SHAPES)
def test_cost_models_equal_reference(mshape):
    for it, d in ((3, 2), (6, 1), (8, 2)):
        assert ops.polar_flops(mshape, iters=it, degree=d) == \
            jops.polar_flops(mshape, iters=it, degree=d)
        assert ops.polar_hbm_bytes(mshape, "float32", iters=it) == \
            jops.polar_hbm_bytes(mshape, np.float32, iters=it)
        for l, q in ((136, 1), (24, 0), (8, 2)):
            assert ops.lowrank_polar_flops(
                mshape, l, iters=it, degree=d, power_iters=q) == \
                jops.lowrank_polar_flops(mshape, l, iters=it, degree=d,
                                         power_iters=q)
            for dt, jdt in (("float32", np.float32),
                            (torch.bfloat16, jnp.bfloat16)):
                assert ops.lowrank_polar_hbm_bytes(
                    mshape, l, dt, iters=it, power_iters=q) == \
                    jops.lowrank_polar_hbm_bytes(mshape, l, jdt, iters=it,
                                                 power_iters=q)


# test_muon_routes_embedding_through_lowrank's settings (tests/test_lowrank.py)
ROUTES = dict(degree=2, iterations=6, warm_alpha_iters=1, sketch_dim=8,
              use_kernels=True)
ROUTES_KW = dict(learning_rate=0.02, lowrank_rank=16, lowrank_oversample=8,
                 lowrank_max_dim=1024, matfn_tol=1e-4)


def test_muon_lowrank_update_matches_reference():
    """One SMOKE Muon update with the tier on: the vocab leaves leave the
    AdamW fallback (no "nu"), every matrix leaf carries the reference's
    int32 "tier", and the parameters and state agree at 1e-5."""
    def each(s, jp, js, named, topt, calls):
        jflat = convert._flatten(jax.tree.map(np.asarray, jp))
        jstate = convert._flatten(jax.tree.map(np.asarray, js["leaves"]))
        for k, p in named:
            np.testing.assert_allclose(p.detach().numpy(), jflat[k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
            for name, v in topt.state[p].items():
                want = jstate[f"{k}.{name}"]
                assert v.dtype == getattr(torch, str(want.dtype)), name
                np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                           atol=1e-5, err_msg=f"{k}.{name}")
        # the vocab views' lowrank chains ran their matrix products
        assert calls["matmul_add"] > 0

    tcfg, jp, js, named, topt = _muon_both(1, "float32", ROUTES, keyed=True,
                                           each=each, **ROUTES_KW)
    state = dict((k, topt.state[p]) for k, p in named)
    lowrank_code = bucketing.TIER_CODES["lowrank"]
    for k in ("embed", "head"):
        assert "nu" not in state[k] and int(state[k]["tier"]) == lowrank_code
    assert int(state["layers.mlp.w_up"]["tier"]) != lowrank_code


@pytest.mark.parametrize("fuse,want", [
    ("off", dict(matmul_add=17, gram=6)),
    ("auto", dict(matmul_add=5, warm_tail=2))])
def test_lowrank_bucket_launches(fuse, want):
    """The kernel-wrapper calls of one PRISM-5 lowrank bucket (a wide
    [2, 64, 256] view, l = 24): the sketch product, two for the power
    iteration, B = Q^T X and the lift (5 K1), and the two polars of 3 warm
    iterations each — on the grid tier (fuse off: K2 + 2 K1 an iteration,
    the count phase 9 of chip_smoke.py gates at full width) or as one
    warm tail each where the [256, 24] and [64, 24] slices fit."""
    cfg = OptimizerConfig(
        name="muon", lowrank_rank=16, lowrank_oversample=8,
        lowrank_max_dim=128,
        prism=PrismConfig(degree=2, iterations=3, warm_alpha_iters=3,
                          sketch_dim=8, use_kernels=True, fuse=fuse))
    assert bucketing.resolve_lowrank_tier(cfg, (64, 256)) == 24
    view = torch.tensor(_rank_l(4, (2,), 64, 256, 24))
    with count_ops() as calls:
        out = bucketing.polar_bucketed([view], cfg, JaxKey(
            jax.random.PRNGKey(0)))
    assert {k: v for k, v in calls.items() if v} == want
    assert tuple(out[0].shape) == (2, 64, 256)
