"""The port's DB-Newton square root (``core/newton.py``) against the
reference on the CPU, and the telemetry contract of every ``matfn`` route
this slice adds (the shapes and dtypes of the appended iteration counts
and statuses, as the reference returns them).

Tolerances: three iterations, before the iteration converges, are held
at 1e-5 of the largest entry: both packages run the same fp32 Cholesky
solves and closed-form quartic fits.  Near convergence the quartic's
coefficients fall to the fp32 rounding floor and the fitted alpha is
arbitrary in either package (it swings between 0 and 2 on the same
input), so longer runs are held against ``eigh`` at the reference's
bounds (tests/test_matfn.py: 1e-3 for A^{1/2}, 5e-3 for A^{-1/2}).
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


@pytest.mark.parametrize("method", ["newton", "newton_classical"])
def test_db_newton_matches_reference(method):
    a = _spd((2,), 24, seed=1, lo=0.05)
    want = jmatfn.sqrtm(jnp.asarray(a), method=method, iters=3)
    got = matfn.sqrtm(torch.tensor(a), method=method, iters=3)
    for g, w in zip(got, want):
        _hold(g, w)


@pytest.mark.parametrize("method,iters", [("newton", 15),
                                          ("newton_classical", 25)])
def test_db_newton_matches_eigh(method, iters):
    a = torch.tensor(_spd((), 48, seed=2, lo=1e-3))
    sq, isq = matfn.sqrtm(a, method=method, iters=iters)
    sq_ref, isq_ref = matfn.sqrtm(a, method="eigh")
    assert _rel(sq, sq_ref) < 1e-3
    assert _rel(isq, isq_ref) < 5e-3
    assert _rel(sq @ sq, a) < 5e-3


def test_failed_cholesky_slice_is_nan_as_reference():
    """A slice that is not positive definite fails its Cholesky: it comes
    out NaN in both packages (the port reads no status back to raise),
    and the SPD slice beside it is held at 1e-5."""
    a = _spd((2,), 16, seed=4, lo=0.2)
    a[1] = -a[1]
    want = jmatfn.sqrtm(jnp.asarray(a), method="newton", iters=2)
    got = matfn.sqrtm(torch.tensor(a), method="newton", iters=2)
    for g, w in zip(got, want):
        assert bool(np.isnan(np.asarray(w[1])).all())
        assert bool(torch.isnan(g[1]).all())
        _hold(g[0], w[0])


def _call(pkg, fn, method, a, tele):
    m = jmatfn if pkg == "jax" else matfn
    key = jax.random.PRNGKey(0)
    key = key if pkg == "jax" else JaxKey(key)
    kw = dict(iters=3, **tele)
    if fn == "inv_proot":
        return m.inv_proot(a, 3, method=method, key=key, **kw)
    if fn == "sqrtm":
        return m.sqrtm(a, method=method, **kw)
    return getattr(m, fn)(a, method=method, key=key, **kw)


ROUTES = [("inv", "solve"), ("inv", "prism_chebyshev"), ("inv", "chebyshev"),
          ("inv", "inverse_newton"), ("inv_proot", "prism"),
          ("inv_proot", "inverse_newton"), ("inv_proot", "eigh"),
          ("inv_sqrtm", "inverse_newton"), ("sqrtm", "newton"),
          ("sqrtm", "newton_classical")]
TELE = [dict(return_iters=True), dict(return_status=True),
        dict(return_iters=True, return_status=True),
        dict(return_info=True, return_iters=True, return_status=True)]


def _structure(x):
    """Nested (shape, dtype) of a result, IterInfo fields included."""
    if isinstance(x, tuple):
        return tuple(_structure(v) for v in x)
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("tele", TELE, ids=["iters", "status", "both",
                                            "info"])
@pytest.mark.parametrize("fn,method", ROUTES)
def test_telemetry_contract_matches_reference(fn, method, tele):
    """(out[, info][, iters][, status]) with the reference's shapes and
    dtypes; the LAPACK routes raise on return_info as the reference does;
    the counts of the fit-free routes are zeros.  The reference's
    Chebyshev ``return_info`` raises NameError (``repro/core/chebyshev.py``
    uses ``_fro`` without importing it): there the port's IterInfo is held
    to the shapes the other families give it."""
    a = _spd((2,), 8, seed=3, lo=0.3)
    if "return_info" in tele and method in ("solve", "eigh"):
        for pkg, x in (("jax", jnp.asarray(a)), ("torch", torch.tensor(a))):
            with pytest.raises(ValueError):
                _call(pkg, fn, method, x, tele)
        return
    if "return_info" in tele and method in ("prism_chebyshev", "chebyshev"):
        with pytest.raises(NameError, match="_fro"):
            _call("jax", fn, method, jnp.asarray(a), tele)
        got = _call("torch", fn, method, torch.tensor(a), tele)
        assert _structure(got) == (((2, 8, 8), "float32"),
                                   (((3, 2), "float32"), ((3, 2), "float32")),
                                   ((2,), "int32"), ((2,), "int8"))
        return
    want = _call("jax", fn, method, jnp.asarray(a), tele)
    got = _call("torch", fn, method, torch.tensor(a), tele)
    assert _structure(got) == _structure(jax.tree.map(np.asarray, want))
    if "return_iters" in tele and "return_info" not in tele:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
