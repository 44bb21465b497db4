"""Shampoo's other inverse-root settings against the reference's
``make_shampoo`` on the CPU: inverse fourth roots (``p_root=4``, PRISM
coupled inverse Newton), DB-Newton (``matfn_method="newton"``), the
``newton_schulz`` fall-through to the coupled PRISM chain, and the
per-leaf loop (``bucketed=False``) with Fig. 5's fitted chain and the
reference's sketches (``JaxKey``).

Every run holds full-rank factors, as ``test_torch_shampoo.py``'s fitted
and ``eigh`` tests do (its docstring says why): ``max_precond_dim=64``
and gradients with conditioned spectra.  Bounds: the file's ``_hold``
(state 1e-5; the inverse roots and the parameters' change within a chain
tolerance of their largest entry), at the warm chain's 2e-4 for the
inverse-Newton, DB-Newton and coupled chains: on these factors three
iterations are far from convergence, where every alpha fit is well posed
and the inverse roots agree to 4e-7 (p = 4) and 6e-5 (DB-Newton).  The
fitted runs (p = 4, per-leaf) hold their inverse roots and the per-leaf
parameters at 1e-5 besides: the bound that shows a sketch drawn under
another key.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.shampoo import make_shampoo
from repro_torch import convert
from repro_torch.configs import gpt2_paper
from repro_torch.models.transformer import param_specs
from repro_torch.optim import muon
from repro_torch.optim.shampoo import Shampoo
from test_torch_prism import JaxKey
from test_torch_shampoo import _grads, _hold, _ocfgs, _smoke
import torch_threads  # noqa: F401  (the worker's share of the cores)

FULL = dict(max_precond_dim=64)


def _both(which, steps, seed, p_root=2, prism_iters=None, **kw):
    """``steps`` updates of the SMOKE params through both packages with
    conditioned grads; step s draws from PRNGKey(s) in both;
    ``prism_iters`` shortens the chain.  Returns (jp, js, named, topt,
    params)."""
    jmodel, params = _smoke()
    grads = _grads(params, steps, seed=seed, conditioned=True)
    jcfg, tcfg = _ocfgs(which, **FULL, **kw)
    if prism_iters is not None:
        jcfg, tcfg = (dataclasses.replace(c, prism=dataclasses.replace(
            c.prism, iterations=prism_iters)) for c in (jcfg, tcfg))
    jopt = make_shampoo(jcfg, jmodel.logical_axes(), p_root=p_root)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    named = [(k, torch.nn.Parameter(v)) for k, v in
             convert.params_from_jax(params, gpt2_paper.SMOKE).items()]
    axes = {k: a for k, (_, a, _) in param_specs(gpt2_paper.SMOKE).items()}
    topt = Shampoo(named, tcfg, axes, p_root=p_root)
    for s, g in enumerate(grads):
        jg = jax.tree.map(jnp.asarray, convert.params_to_jax(
            {k: torch.from_numpy(v) for k, v in g.items()}))
        jp, js = jopt.update(jg, js, jp, s, jax.random.PRNGKey(s))
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        topt.step(key=JaxKey(jax.random.PRNGKey(s)))
    return jp, js, named, topt, params


def _hold_roots(named, topt, js, tol=1e-5):
    """Every inverse root (Linv, Rinv) within ``tol`` of its largest
    entry: the same fp32 chain from the same sketches."""
    jstate = convert._flatten(jax.tree.map(
        lambda a: np.asarray(a, np.float32), js["leaves"]))
    for k, p in named:
        for name in ("Linv", "Rinv"):
            if name in topt.state[p]:
                want = jstate[f"{k}.{name}"]
                scale = np.abs(want).max()
                np.testing.assert_allclose(
                    topt.state[p][name].numpy() / scale, want / scale,
                    rtol=0, atol=tol, err_msg=f"{k}.{name}")


def test_inverse_fourth_root_matches_reference():
    """p_root=4 runs PRISM coupled inverse Newton (3 fitted iterations of
    the default Shampoo PrismConfig) on every full factor; the diagonal
    fallback takes the 1/(2p) power.  The inverse roots are held at 1e-5
    besides: they agree to 4e-7, and fitted from exact traces instead of
    the reference's sketches they move by 5e-5."""
    jp, js, named, topt, params = _both("warm", 1, seed=6, p_root=4)
    _hold(named, topt, jp, js, "warm", params)
    _hold_roots(named, topt, js)


def test_db_newton_matches_reference():
    """matfn_method="newton": DB-Newton's Cholesky chain, fp32, two
    steps."""
    jp, js, named, topt, params = _both("warm", 2, seed=7,
                                        matfn_method="newton")
    _hold(named, topt, jp, js, "warm", params)


def test_newton_schulz_falls_through_to_prism():
    """matfn_method="newton_schulz" at p = 2 runs the coupled PRISM chain
    in both packages: the port's update is bitwise its prism update and
    within the warm chain's bound of the reference's."""
    jp, js, named, topt, params = _both("warm", 1, seed=8,
                                        matfn_method="newton_schulz")
    _hold(named, topt, jp, js, "warm", params)
    _, _, named2, topt2, _ = _both("warm", 1, seed=8)
    for (k, p), (_, q) in zip(named, named2):
        assert torch.equal(p, q), k


def test_per_leaf_fitted_matches_reference():
    """bucketed=False with Fig. 5's fitted chain (2 of its 5 iterations,
    for time) and an adaptive ``matfn_tol``, whose per-factor telemetry
    ("Linv_iters", "Rinv_status", ...) ``_hold`` holds equal: each factor
    draws from the step key folded with its leaf's index in the
    reference's leaf order, then with 1 for R.  Held at 1e-5: the SMOKE model's
    ``named_parameters`` order differs from that order, so a sketch keyed
    by the port's own position moves the inverse roots past it."""
    names = list(param_specs(gpt2_paper.SMOKE))
    assert muon.leaf_order(names) != list(range(len(names)))
    jp, js, named, topt, params = _both("fig5", 1, seed=9, bucketed=False,
                                        prism_iters=2, matfn_tol=0.05)
    assert topt.cfg.matfn_telemetry
    _hold(named, topt, jp, js, "fig5", params)
    _hold_roots(named, topt, js)
    jflat = convert._flatten(jax.tree.map(np.asarray, jp))
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=0,
                                   atol=1e-5, err_msg=k)
    assert topt.cfg.bucketed is False
