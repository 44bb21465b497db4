"""The port's coupled inverse Newton (``core/inverse_newton.py``) and the
residual polynomials of the inverse-Newton and Chebyshev families against
the reference on the CPU, with the same numpy inputs and the same sketches
(``JaxKey``).

Tolerances: the polynomial tables are equal exactly.  Each chain runs the
same fp32 products in both packages and fits alpha from the same sketched
traces, so its output is held at 1e-5 of its largest entry (the alpha
fit's own bound, tests/test_torch_prism.py); against ``eigh`` the port is
held at the reference's 2e-3 relative (tests/test_matfn.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matfn as jmatfn
from repro.core import polynomials as jpoly
from repro_torch.core import matfn
from repro_torch.core import polynomials as poly
from repro_torch.core import prism
from test_torch_prism import JaxKey
import torch_threads  # noqa: F401  (the worker's share of the cores)

TOL = 1e-5


def _spd(lead, n, seed, lo=0.1, hi=1.0):
    """SPD [*lead, n, n] with eigenvalues uniform in [lo, hi]."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal(tuple(lead) + (n, n)))
    lam = rng.uniform(lo, hi, tuple(lead) + (1, n))
    return ((q * lam) @ np.swapaxes(q, -1, -2)).astype(np.float32)


def _hold(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_residual_polynomials_equal_reference(p):
    """h(x; alpha), its trace-weight table and the minimizer's dispatch
    (closed form up to p = 2, the grid above) as in the reference."""
    got = poly.inverse_newton_residual(p)
    want = jpoly.inverse_newton_residual(p)
    assert got.polys == want.polys
    np.testing.assert_array_equal(poly.trace_weight_matrix(got),
                                  jpoly.trace_weight_matrix(want))
    got, want = poly.chebyshev_residual(), jpoly.chebyshev_residual()
    assert got.polys == want.polys
    np.testing.assert_array_equal(poly.trace_weight_matrix(got),
                                  jpoly.trace_weight_matrix(want))


@pytest.mark.parametrize("method", ["prism", "inverse_newton"])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_inv_proot_matches_reference(p, method):
    """A fitted (prism) or classical (inverse_newton: a = 1/p) chain of 12
    iterations on a batch of two SPD slices."""
    a = _spd((2,), 24, seed=p)
    key = jax.random.PRNGKey(p)
    want = jmatfn.inv_proot(jnp.asarray(a), p=p, method=method, iters=12,
                            key=key)
    got = matfn.inv_proot(torch.tensor(a), p=p, method=method, iters=12,
                          key=JaxKey(key))
    _hold(got, want)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_inv_proot_matches_eigh(p):
    """The reference's oracle test (tests/test_matfn.py) on the port."""
    a = torch.tensor(_spd((), 48, seed=10 + p))
    got = matfn.inv_proot(a, p=p, iters=40, key=JaxKey(jax.random.PRNGKey(0)))
    assert _rel(got, matfn.inv_proot(a, p=p, method="eigh")) < 2e-3


@pytest.mark.parametrize("p", [1, 2, 4])
def test_adaptive_tol_matches_reference(p):
    """tol=1e-3 with a budget of 40: the per-slice iterations used and
    the guardian statuses are equal, the outputs within TOL."""
    a = np.stack([_spd((), 24, 20, lo=0.3), _spd((), 24, 21, lo=0.02)])
    key = jax.random.PRNGKey(3)
    want, wused, wst = jmatfn.inv_proot(
        jnp.asarray(a), p=p, iters=40, key=key, tol=1e-3,
        return_iters=True, return_status=True)
    got, used, st = matfn.inv_proot(
        torch.tensor(a), p=p, iters=40, key=JaxKey(key), tol=1e-3,
        return_iters=True, return_status=True)
    np.testing.assert_array_equal(used.numpy(), np.asarray(wused))
    np.testing.assert_array_equal(st.numpy(), np.asarray(wst))
    assert used.dtype == torch.int32 and st.dtype == torch.int8
    assert int(used.max()) < 40 and int(used[0]) < int(used[1])
    _hold(got, want)


def test_zero_slice_guard_matches_reference():
    """An all-zero slice beside a real one: c = 1 keeps its iterates
    finite (X = prod(1 + a_k) I, M = 0), it never certifies (MAXITER),
    and the real slice is held at TOL.  On R = I the objective m(alpha)
    is flat (h(1; alpha) = 1), so each fit picks whichever candidate the
    traces' last bits favour, in either package: the zero slice's
    multiple of I is held to its form, not to the reference's value."""
    a = np.stack([_spd((), 16, 30), np.zeros((16, 16), np.float32)])
    key = jax.random.PRNGKey(4)
    want, wused, wst = jmatfn.inv_proot(
        jnp.asarray(a), p=2, iters=20, key=key, tol=1e-3,
        return_iters=True, return_status=True)
    got, used, st = matfn.inv_proot(
        torch.tensor(a), p=2, iters=20, key=JaxKey(key), tol=1e-3,
        return_iters=True, return_status=True)
    assert bool(torch.isfinite(got).all())
    assert int(st[1]) == prism.STATUS_MAXITER
    np.testing.assert_array_equal(used.numpy(), np.asarray(wused))
    np.testing.assert_array_equal(st.numpy(), np.asarray(wst))
    _hold(got[0], want[0])
    c = float(got[1, 0, 0])
    assert torch.equal(got[1], c * torch.eye(16)) and c > 1.0


@pytest.mark.parametrize("p", [2, 3])
def test_return_info_matches_reference(p):
    """The per-iteration alphas (fitted within [1/p, 2/p]) and residual
    norms, beside the output; the adaptive loop is off under return_info
    whatever tol says.  Four iterations keep ||R_k||_F above 1e-2: past
    that the objective flattens like ||R_k||^2 and its argmin moves with
    the traces' last bits (6.5e-5 at ||R|| = 1e-3, p = 2)."""
    a = _spd((2,), 16, seed=40 + p)
    key = jax.random.PRNGKey(5)
    want, winfo = jmatfn.inv_proot(jnp.asarray(a), p=p, iters=4, key=key,
                                   return_info=True, tol=1e-3)
    got, info = matfn.inv_proot(torch.tensor(a), p=p, iters=4,
                                key=JaxKey(key), return_info=True, tol=1e-3)
    assert tuple(info.alphas.shape) == (4, 2)
    assert bool(((info.alphas >= 1.0 / p) & (info.alphas <= 2.0 / p)).all())
    np.testing.assert_allclose(info.alphas.numpy(), np.asarray(winfo.alphas),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(info.residual_fro.numpy(),
                               np.asarray(winfo.residual_fro), rtol=TOL,
                               atol=TOL)
    _hold(got, want)


def test_inv_sqrtm_inverse_newton_matches_reference():
    """matfn.inv_sqrtm(method="inverse_newton") is inv_proot at p = 2."""
    a = _spd((3,), 20, seed=50, lo=0.05)
    key = jax.random.PRNGKey(6)
    want = jmatfn.inv_sqrtm(jnp.asarray(a), method="inverse_newton",
                            iters=15, key=key)
    got = matfn.inv_sqrtm(torch.tensor(a), method="inverse_newton",
                          iters=15, key=JaxKey(key))
    _hold(got, want)
    ref = matfn.sqrtm(torch.tensor(a), method="eigh")[1]
    assert _rel(got, ref) < 5e-3
