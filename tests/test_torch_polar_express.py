"""The port's PolarExpress baseline and SVD polar against the reference on
the CPU: ``matfn.polar``/``sqrtm``/``inv_sqrtm(method="polar_express")``
in fp32 and bf16 (every product through ``newton_schulz._mm``'s plain
path in both packages), the ``return_info`` trajectory and the zero
``return_iters``/``return_status`` telemetry, and ``polar(method="svd")``.

Tolerances, relative to the largest entry of the reference's result:
1e-5 in fp32 (the same fp32 products in another summation order, eight
iterations) and 2e-2 in bf16 (a few bf16 half-ulps of 2^-9 each, as the
reference holds its bf16 chains); SVD 1e-5 on full-rank inputs, whose
polar factor is well determined.  One exception: the coupled chain's
``return_info`` trajectory, 5e-5.  Its middle iterations (the first
coefficients are 8.3, -23.6, 17.3) amplify the summation-order
differences of Y X to 1.3e-5 of the trajectory's largest entry before the
chain contracts them again: X and Y themselves agree to 9e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import PrismConfig as JPrism
from repro.core import matfn as jmatfn
from repro_torch.config import PrismConfig
from repro_torch.core import matfn, polar_express
import torch_threads  # noqa: F401  (the worker's share of the cores)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _gauss(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _spd(lead, n, seed):
    a = _gauss(lead + (n, 2 * n), seed)
    return (a @ np.swapaxes(a, -1, -2) / (2 * n)).astype(np.float32)


def test_coefficients_are_the_reference_schedule():
    from repro.core import polar_express as jpe

    assert polar_express.POLAR_EXPRESS_COEFFS == jpe.POLAR_EXPRESS_COEFFS
    assert polar_express._SAFETY == jpe._SAFETY


@pytest.mark.parametrize("shape", [(3, 48, 24), (2, 24, 40), (32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_polar_matches_reference(shape, dtype):
    a = _gauss(shape, sum(shape))
    want = jmatfn.polar(jnp.asarray(a), method="polar_express",
                        cfg=JPrism(dtype=dtype))
    got = matfn.polar(torch.from_numpy(a), method="polar_express",
                      cfg=PrismConfig(dtype=dtype))
    assert got.dtype == torch.float32
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sqrtm_and_inv_sqrtm_match_reference(dtype):
    a = _spd((2,), 24, 5)
    jX, jY = jmatfn.sqrtm(jnp.asarray(a), method="polar_express",
                          cfg=JPrism(dtype=dtype))
    X, Y = matfn.sqrtm(torch.from_numpy(a), method="polar_express",
                       cfg=PrismConfig(dtype=dtype))
    _close(X, jX, TOL[dtype])
    _close(Y, jY, TOL[dtype])
    Yi = matfn.inv_sqrtm(torch.from_numpy(a), method="polar_express",
                         cfg=PrismConfig(dtype=dtype))
    _close(Yi, jY, TOL[dtype])


@pytest.mark.parametrize("fn", ["polar", "sqrtm"])
def test_info_trajectory_and_zero_telemetry(fn):
    """return_info gives ||I - M||_F before each of the iterations;
    return_iters/return_status append int32/int8 zeros of the lead shape
    after it, as the reference's _run_fixed_schedule does."""
    a = _gauss((3, 40, 20), 1) if fn == "polar" else _spd((3,), 20, 2)
    kw = dict(method="polar_express", iters=6, return_info=True,
              return_iters=True, return_status=True)
    jout, jinfo, jit, jst = getattr(jmatfn, fn)(jnp.asarray(a), **kw)
    out, info, it, st = getattr(matfn, fn)(torch.from_numpy(a), **kw)
    assert tuple(info.shape) == (6, 3)
    _close(info, jinfo, 1e-5 if fn == "polar" else 5e-5)
    for got, want in zip(out if fn == "sqrtm" else (out,),
                         jout if fn == "sqrtm" else (jout,)):
        _close(got, want, 1e-5)
    assert it.dtype == torch.int32 and st.dtype == torch.int8
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert not it.any() and not st.any()
    # without return_info the telemetry follows the result directly
    out2, it2 = getattr(matfn, fn)(torch.from_numpy(a),
                                   method="polar_express", iters=6,
                                   return_iters=True)
    assert tuple(it2.shape) == (3,)


@pytest.mark.parametrize("shape", [(3, 40, 24), (2, 16, 30)])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_svd_polar_matches_reference(shape, in_dtype):
    """Pinned fp32 (LAPACK), rounded back to the input dtype; telemetry
    through the shim: int32/int8 zeros."""
    a = _gauss(shape, 7)
    ja = jnp.asarray(a, dtype=jnp.dtype(in_dtype))
    ta = torch.from_numpy(a).to(getattr(torch, in_dtype))
    want, jit, jst = jmatfn.polar(ja, method="svd", return_iters=True,
                                  return_status=True)
    got, it, st = matfn.polar(ta, method="svd", return_iters=True,
                              return_status=True)
    assert got.dtype == ta.dtype
    _close(got, want, 1e-5 if in_dtype == "float32" else TOL[in_dtype])
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    with pytest.raises(ValueError, match="return_info"):
        matfn.polar(ta, method="svd", return_info=True)
