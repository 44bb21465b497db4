"""The port's Chebyshev inverse (``core/chebyshev.py``) and
``matfn.inv``'s routes against the reference on the CPU, with the same
numpy inputs and sketches (``JaxKey``).

Tolerances: the chains run the same fp32 products in both packages and
fit alpha from the same traces, so outputs are held at 1e-5 of their
largest entry (tests/test_torch_prism.py's fit bound); against ``solve``
the port is held at the reference's 1e-3 relative (tests/test_matfn.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matfn as jmatfn
from repro_torch.core import matfn
from test_torch_inverse_newton import _hold, _rel, _spd
from test_torch_prism import JaxKey
import torch_threads  # noqa: F401  (the worker's share of the cores)


def _nonsym(n, seed):
    """Gaussian / 10 + I: full rank, not symmetric."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) / 10 + np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("kind,method", [
    ("spd", "prism_chebyshev"), ("spd", "chebyshev"),
    ("spd", "inverse_newton"), ("spd", "solve"),
    ("nonsym", "prism_chebyshev"), ("nonsym", "chebyshev"),
    ("nonsym", "solve")])
def test_inv_matches_reference(method, kind):
    """Every route of ``matfn.inv`` on a batch of two slices (inverse
    Newton on SPD inputs only: it needs them), 6 iterations: the first
    four or five fits sit at the bound alpha = 2, the later ones inside
    it, where the sketch they are fitted from moves the result."""
    a = (_spd((2,), 24, seed=1, lo=0.05) if kind == "spd" else
         np.stack([_nonsym(24, 2), _nonsym(24, 3)]))
    key = jax.random.PRNGKey(1)
    want = jmatfn.inv(jnp.asarray(a), method=method, iters=6, key=key)
    got = matfn.inv(torch.tensor(a), method=method, iters=6,
                    key=JaxKey(key))
    _hold(got, want)


@pytest.mark.parametrize("method", ["prism_chebyshev", "chebyshev"])
def test_inv_matches_solve(method):
    """The reference's oracle tests (tests/test_matfn.py) on the port."""
    key = JaxKey(jax.random.PRNGKey(0))
    a = torch.tensor(_spd((), 48, seed=4, lo=0.05))
    got = matfn.inv(a, method=method, iters=40, key=key)
    assert _rel(got, matfn.inv(a, method="solve")) < 1e-3
    b = torch.tensor(_nonsym(48, 5))
    got = matfn.inv(b, method=method, iters=40, key=key)
    assert _rel(b @ got, torch.eye(48)) < 1e-3


def test_adaptive_tol_matches_reference():
    """tol=1e-3 with a budget of 40: equal iterations used and statuses,
    outputs within 1e-5."""
    a = np.stack([_spd((), 24, 6, lo=0.3), _spd((), 24, 7, lo=0.01)])
    key = jax.random.PRNGKey(2)
    want, wused, wst = jmatfn.inv(jnp.asarray(a), iters=40, key=key,
                                  tol=1e-3, return_iters=True,
                                  return_status=True)
    got, used, st = matfn.inv(torch.tensor(a), iters=40, key=JaxKey(key),
                              tol=1e-3, return_iters=True,
                              return_status=True)
    np.testing.assert_array_equal(used.numpy(), np.asarray(wused))
    np.testing.assert_array_equal(st.numpy(), np.asarray(wst))
    assert int(used[0]) < int(used[1]) < 40
    _hold(got, want)


def test_frozen_slice_bitwise_stable_chebyshev():
    """As tests/test_adaptive_tol.py: once the fast slice certifies, later
    iterations driven by the slow one leave it bitwise as it was — a
    budget cut just after it froze gives the same slice bit for bit."""
    a = torch.tensor(np.stack([_spd((), 24, 8, lo=0.3),
                               _spd((), 24, 9, lo=0.01)]))
    key = JaxKey(jax.random.PRNGKey(3))
    full, used = matfn.inv(a, iters=40, key=key, tol=1e-3,
                           return_iters=True)
    assert int(used[0]) < int(used[1]) <= 40
    cut, used_cut = matfn.inv(a, iters=int(used[0]) + 1, key=key, tol=1e-3,
                              return_iters=True)
    assert int(used_cut[0]) == int(used[0])
    assert torch.equal(full[0], cut[0])
