"""The port's §15 containment against the reference on the CPU (the
counterparts of tests/test_guardian.py's adversarial spectra): polar,
``inv`` and ``inv_proot(p=4)`` on an exact zero, a rank-1 spike and
kappa ~ 1e8, in fp32 and bf16, 32 wide, with the reference's inputs and
sketches (``JaxKey``).  FINITE INPUT -> FINITE OUTPUT, and the port
reports the reference's guardian status and iteration count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import PrismConfig as JPrism
from repro.core import matfn as jmatfn
from repro.core import random_matrices as rm
from repro_torch.config import PrismConfig
from repro_torch.core import matfn, prism
from test_torch_prism import JaxKey
import torch_threads  # noqa: F401  (the worker's share of the cores)

SPECTRA = ("zero", "rank1_spike", "kappa1e8")
DTYPES = ("float32", "bfloat16")
VALID = {prism.STATUS_OK, prism.STATUS_MAXITER, prism.STATUS_QUARANTINED}
ITERS = 10
TOL = 1e-2


def _spectrum(key, name, n=32, spd=False):
    """tests/test_guardian.py::_spectrum, as numpy."""
    if name == "zero":
        return np.zeros((n, n), np.float32)
    if name == "rank1_spike":
        A = rm.with_spectrum(key, n, n, jnp.zeros((n,)).at[0].set(1e4))
    else:
        A = rm.log_uniform_spectrum(key, n, n, 1e-8)
    if spd:
        A = A @ A.T / 2 + 1e-30 * jnp.eye(n)
    return np.array(A, np.float32)


def _run(family, A, key, dtype):
    """(result, iterations, status) of ``family`` in one package: the
    reference's on jax arrays, the port's on torch tensors."""
    if isinstance(A, torch.Tensor):
        m, k, dt = matfn, JaxKey(key), getattr(torch, dtype)
        cfg = PrismConfig(degree=2, iterations=ITERS, warm_alpha_iters=1,
                          sketch_dim=8, dtype=dtype, tol=TOL)
    else:
        m, k, dt = jmatfn, key, jnp.dtype(dtype)
        cfg = JPrism(degree=2, iterations=ITERS, warm_alpha_iters=1,
                     sketch_dim=8, dtype=dtype, tol=TOL)
    kw = dict(return_iters=True, return_status=True)
    if family == "polar":
        return m.polar(A, method="prism", cfg=cfg, key=k, **kw)
    if family == "inv":
        return m.inv(A, iters=ITERS, key=k, tol=TOL, dtype=dt, **kw)
    return m.inv_proot(A, p=4, iters=ITERS, key=k, tol=TOL, dtype=dt, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SPECTRA)
@pytest.mark.parametrize("family", ["polar", "inv", "inv_proot"])
def test_containment_matches_reference(key, family, name, dtype):
    a = _spectrum(key, name, spd=family != "polar")
    _, jit, jst = _run(family, jnp.asarray(a), key, dtype)
    X, it, st = _run(family, torch.from_numpy(a), key, dtype)
    assert bool(torch.isfinite(X.float()).all()), (family, name, dtype)
    assert st.dtype == torch.int8 and int(st) in VALID
    assert 0 <= int(it) <= ITERS
    assert (int(st), int(it)) == (int(jst), int(jit))
    if name == "zero" or (family == "inv" and name == "rank1_spike"):
        # no signal, or a singular input to invert: never "certified"
        assert int(st) != prism.STATUS_OK
