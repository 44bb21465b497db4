"""The port's ``matfn.polar`` against ``repro.core.matfn.polar`` on the
CPU, for the warm-only PRISM chain (Muon's PRISM-5 config) and the
classical Newton-Schulz chain, with ``use_kernels=True`` and the fused
tier forced on and off, so that both tiers' accumulation orders are held.

Tolerance: 2e-4 (fp32) and 5e-2 (bf16), the reference's bound for the
fused warm tail against its oracle (tests/test_fused_iter.py), since a
polar call is a chain of those kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import PrismConfig as JPrism
from repro.core import matfn as jmatfn
from repro_torch.config import PrismConfig
from repro_torch.core import matfn, newton_schulz

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


def test_fitted_config_raises():
    cfg = PrismConfig(degree=2, iterations=5, warm_alpha_iters=3)
    with pytest.raises(NotImplementedError, match="slice 2"):
        matfn.polar(torch.ones(2, 8, 8), cfg=cfg)


def test_tol_raises():
    cfg = PrismConfig(degree=2, iterations=3, warm_alpha_iters=3, tol=1e-2)
    with pytest.raises(NotImplementedError, match="slice 2"):
        newton_schulz.polar(torch.ones(2, 8, 8), cfg=cfg)


def test_unported_methods_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        matfn.polar(torch.ones(8, 8), method="polar_express")
