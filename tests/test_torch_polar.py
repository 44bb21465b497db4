"""The port's ``matfn.polar`` against ``repro.core.matfn.polar`` on the
CPU, for the warm-only PRISM chain (Muon's PRISM-5 config), the fitted
PRISM chains (PRISM-3 and others, sketches drawn through ``JaxKey``) and
the classical Newton-Schulz chain, with ``use_kernels=True`` and the fused
tier forced on and off, so that both tiers' accumulation orders are held.

Tolerance: 2e-4 (fp32) and 5e-2 (bf16) for the warm chains, the
reference's bound for the fused warm tail against its oracle
(tests/test_fused_iter.py), since a polar call is a chain of those
kernels; 5e-3 for a fitted chain (tests/test_kernels.py), whose alpha
depends on sketched traces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import PrismConfig as JPrism
from repro.core import matfn as jmatfn
from repro_torch.config import PrismConfig
from repro_torch.core import matfn, newton_schulz
from test_torch_prism import JaxKey

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
SHAPES = [(3, 96, 40), (2, 24, 72), (30, 16, 64), (48, 48)]


def _cfgs(dtype, fuse, method):
    kw = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True, fuse=fuse, dtype=dtype)
    if method == "newton_schulz":
        kw.update(iterations=4, warm_alpha_iters=0)
    return JPrism(**kw), PrismConfig(**kw)


def _both(a, method, dtype, fuse, in_dtype="float32"):
    jcfg, tcfg = _cfgs(dtype, fuse, method)
    ja = jnp.asarray(a, dtype=jnp.dtype(in_dtype))
    ta = torch.tensor(a).to(getattr(torch, in_dtype))
    want = jmatfn.polar(ja, method=method, cfg=jcfg)
    got = matfn.polar(ta, method=method, cfg=tcfg)
    assert got.dtype == ta.dtype and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", ["prism", "newton_schulz"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", ["on", "off"])
def test_polar_matches_reference(shape, method, dtype, fuse):
    a = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    got, want = _both(a, method, dtype, fuse)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_bf16_bucket_in_bf16(fuse):
    """A bucket gathered in bf16 (matfn_dtype=bfloat16) stays bf16."""
    a = np.random.default_rng(5).standard_normal((4, 64, 16)).astype(
        np.float32)
    got, want = _both(a, "prism", "bfloat16", fuse, in_dtype="bfloat16")
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", ["on", "off"])
def test_zero_slice_passes_through_as_zero(dtype, fuse):
    """The _safe_fro clamp: a zero slice normalizes to 0, not NaN, and
    stays exactly zero through the chain, beside a live slice."""
    a = np.random.default_rng(6).standard_normal((3, 40, 24)).astype(
        np.float32)
    a[1] = 0.0
    got, want = _both(a, "prism", dtype, fuse)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_the_two_tiers_coincide_for_the_polar_family():
    """The grid tier rounds after every GEMM; the fused tier rounds each
    GEMM's operand.  For the polar family these are the same roundings,
    so the two tiers agree to the last bit in bf16 too."""
    a = np.random.default_rng(7).standard_normal((3, 64, 16)).astype(
        np.float32)
    _, on = _cfgs("bfloat16", "on", "prism")
    _, off = _cfgs("bfloat16", "off", "prism")
    x = torch.tensor(a)
    torch.testing.assert_close(matfn.polar(x, cfg=on),
                               matfn.polar(x, cfg=off), rtol=0, atol=0)


FIT_TOL = 5e-3


def _fitted(a, dtype="float32", key=None, **kw):
    """The same fitted chain through both packages (``key`` a JAX key,
    handed to the port as a ``JaxKey``)."""
    ja = jnp.asarray(a)
    want = jmatfn.polar(ja, method="prism", cfg=JPrism(dtype=dtype, **kw),
                        key=key)
    got = matfn.polar(torch.tensor(a), method="prism",
                      cfg=PrismConfig(dtype=dtype, **kw),
                      key=None if key is None else JaxKey(key))
    assert tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


def test_fitted_config_raises():
    """The fitted configuration (two fitted iterations after three warm
    ones) runs and matches the reference, with and without a key."""
    a = np.random.default_rng(8).standard_normal((2, 8, 8)).astype(
        np.float32)
    kw = dict(degree=2, iterations=5, warm_alpha_iters=3)
    for key in (None, jax.random.PRNGKey(1)):
        got, want = _fitted(a, key=key, **kw)
        np.testing.assert_allclose(got, want, rtol=FIT_TOL, atol=FIT_TOL)


def test_tol_raises():
    """A tol runs the adaptive loop (here on warm iterations only, which
    never consult it) and matches the reference."""
    a = np.random.default_rng(9).standard_normal((2, 8, 8)).astype(
        np.float32)
    kw = dict(degree=2, iterations=3, warm_alpha_iters=3, tol=1e-2)
    got = newton_schulz.polar(torch.tensor(a), cfg=PrismConfig(**kw))
    want = jmatfn.polar(jnp.asarray(a), cfg=JPrism(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("shape", [(3, 96, 40), (30, 16, 64), (48, 48)])
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", ["on", "off"])
def test_fitted_polar_matches_reference(shape, degree, dtype, fuse):
    """PRISM-3 (degree 1) and its degree-2 twin: three warm iterations,
    then two fitted ones through K6/K7 (fused) or K2/chain/K1 (grid)."""
    a = np.random.default_rng(sum(shape) + degree).standard_normal(
        shape).astype(np.float32)
    got, want = _fitted(a, dtype, key=jax.random.PRNGKey(degree),
                        degree=degree, iterations=5, warm_alpha_iters=3,
                        sketch_dim=8, use_kernels=True, fuse=fuse)
    np.testing.assert_allclose(got, want, rtol=FIT_TOL, atol=FIT_TOL)


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_fitted_polar_from_the_first_iteration(fuse):
    """warm_alpha_iters=1 (the quickstart's setting): the fitted chain
    does most of the work, and the result is orthonormal."""
    a = np.random.default_rng(10).standard_normal((4, 64, 24)).astype(
        np.float32)
    got, want = _fitted(a, key=jax.random.PRNGKey(0), degree=2,
                        iterations=8, warm_alpha_iters=1, use_kernels=True,
                        fuse=fuse)
    np.testing.assert_allclose(got, want, rtol=FIT_TOL, atol=FIT_TOL)
    G = np.swapaxes(got, -1, -2) @ got
    assert np.abs(G - np.eye(24)).max() < 1e-2


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_n_real_on_a_padded_stack_matches_reference(fuse):
    """Zero-padded slices with their real Gram extent: the fit ignores the
    padding exactly, in both packages."""
    rng = np.random.default_rng(11)
    n_real = np.array([24, 20, 13], np.int32)
    a = np.zeros((3, 64, 24), np.float32)
    for i, r in enumerate(n_real):
        a[i, :, :r] = rng.standard_normal((64, r))
    kw = dict(degree=1, iterations=5, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True, fuse=fuse)
    key = jax.random.PRNGKey(5)
    want = jmatfn.polar(jnp.asarray(a), method="prism", cfg=JPrism(**kw),
                        key=key, n_real=jnp.asarray(n_real))
    got = matfn.polar(torch.tensor(a), method="prism",
                      cfg=PrismConfig(**kw), key=JaxKey(key),
                      n_real=torch.tensor(n_real))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FIT_TOL,
                               atol=FIT_TOL)
    for i, r in enumerate(n_real):
        assert not got[i, :, r:].any()  # pad columns stay exactly zero


def test_return_info_matches_reference():
    a = np.random.default_rng(12).standard_normal((2, 40, 20)).astype(
        np.float32)
    kw = dict(degree=1, iterations=5, warm_alpha_iters=3, sketch_dim=8,
              use_kernels=True)
    key = jax.random.PRNGKey(6)
    jX, jinfo, jit, jst = jmatfn.polar(
        jnp.asarray(a), method="prism", cfg=JPrism(**kw), key=key,
        return_info=True, return_iters=True, return_status=True)
    X, info, it, st = matfn.polar(
        torch.tensor(a), method="prism", cfg=PrismConfig(**kw),
        key=JaxKey(key), return_info=True, return_iters=True,
        return_status=True)
    assert isinstance(info, newton_schulz.IterInfo)
    assert tuple(info.alphas.shape) == (5, 2)
    np.testing.assert_allclose(info.alphas.numpy(), np.asarray(jinfo.alphas),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(info.residual_fro.numpy(),
                               np.asarray(jinfo.residual_fro), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=FIT_TOL,
                               atol=FIT_TOL)


def test_unported_methods_raise():
    """svd and polar_express now run (tests/test_torch_polar_express.py
    holds them against the reference); every method of the reference is
    ported, and one its polar does not have raises ValueError from the
    Newton-Schulz family, as in the reference."""
    a = torch.eye(8) + 0.1 * torch.ones(8, 8)
    for method in ("svd", "polar_express"):
        U = matfn.polar(a, method=method)
        torch.testing.assert_close(U.T @ U, torch.eye(8), rtol=0,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="chebyshev"):
        matfn.polar(a, method="chebyshev")
