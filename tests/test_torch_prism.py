"""The port's alpha fit against the reference on the CPU: sketch keys,
the polynomial tables and minimizers, sketched traces, ``fit_alpha`` and
the §11/§15 adaptive loop (``repro_torch.core`` vs ``repro.core``).

Sketches come from ``JaxKey``: the port's key interface (``fold_in``,
``normal``) built on ``jax.random`` and carried across through numpy, so
both packages draw bit-identical sketches.

Tolerances: the minimizer and the fit from the same fp32 traces 1e-5; the
sketched traces 2e-4 (fp32) and 5e-2 (bf16), tests/test_kernels.py; a
fitted polar chain 5e-3, tests/test_kernels.py; tol=None against a
never-certifying adaptive run 1e-6, tests/test_adaptive_tol.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import PrismConfig as JPrism
from repro.core import matfn as jmatfn
from repro.core import polynomials as jpoly
from repro.core import prism as jprism
from repro.core import random_matrices as rm
from repro.core import sketch as jsketch
from repro_torch.config import PrismConfig
from repro_torch.core import matfn, newton_schulz
from repro_torch.core import polynomials as poly
from repro_torch.core import prism, sketch
from repro_torch.core.rng import Key
from repro_torch.kernels import ops
import torch_threads  # noqa: F401  (the worker's share of the cores)

TRACE_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
CHAIN_TOL = 5e-3


class JaxKey:
    """The port's key interface on ``jax.random`` (tests only)."""

    def __init__(self, key):
        self.key = key

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def normal(self, shape, dtype, device):
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        a = jax.random.normal(self.key, tuple(shape), jd)
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            device=device, dtype=dtype)

    def gumbel(self, shape, dtype, device):
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        a = jax.random.gumbel(self.key, tuple(shape), jd)
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            device=device, dtype=dtype)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _sym(rng, lead, n, scale):
    a = rng.standard_normal(lead + (n, n)) / scale
    return (0.5 * (a + np.swapaxes(a, -1, -2))).astype(np.float32)


def _residuals(seed, lead, n):
    """Polar residuals I - X^T X of normalized random X: spectra in
    [-1, 1), the inputs the fit sees."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (2 * n, n))
    x /= np.linalg.norm(x, axis=(-2, -1), keepdims=True)
    x *= rng.uniform(1.0, 3.0, lead + (1, 1))  # move the spectra around
    return (np.eye(n) - np.swapaxes(x, -1, -2) @ x).astype(np.float32)


# ------------------------------------------------------------ keys, sketches

def test_key_is_deterministic_and_folds_apart():
    a = Key(7).fold_in(3).normal((4, 5), torch.float32, "cpu")
    b = Key(7).fold_in(3).normal((4, 5), torch.float32, "cpu")
    c = Key(7).fold_in(4).normal((4, 5), torch.float32, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert Key(7).fold_in(3).seed == Key(7).fold_in(3).seed
    assert Key(7).fold_in(3).seed != Key(3).fold_in(7).seed
    h = Key(7).normal((2, 3), torch.bfloat16, "cpu")
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (2, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gaussian_sketch_matches_reference_bit_for_bit(dtype):
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    want = jsketch.gaussian_sketch(key, 8, 40, dtype=jnp.dtype(dtype))
    got = sketch.gaussian_sketch(JaxKey(key), 8, 40,
                                 dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (8, 40)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_port_key_draws_a_unit_gaussian_sketch():
    S = sketch.gaussian_sketch(Key(1), 8, 4096)
    assert abs(float(S.mean())) < 0.01
    assert abs(float((S * S).sum(0).mean()) - 1.0) < 0.05


# ------------------------------------------------------- polynomial tables

@pytest.mark.parametrize("d", [1, 2])
def test_residual_polynomial_and_weights_match_reference(d):
    ap, jap = poly.newton_schulz_residual(d), jpoly.newton_schulz_residual(d)
    assert ap.polys == jap.polys
    np.testing.assert_array_equal(poly.trace_weight_matrix(ap),
                                  jpoly.trace_weight_matrix(jap))
    assert poly.max_trace_power(ap) == jpoly.max_trace_power(jap) == 4 * d + 2
    x, a = 0.3, 1.1
    np.testing.assert_allclose(ap.eval(x, a), float(jap.eval(x, a)),
                               rtol=1e-6)


def test_cubic_roots_match_reference():
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.standard_normal(64).astype(np.float32) for _ in range(4))
    got = poly.cubic_roots(*(_t(v) for v in (a, b, c, d)))
    want = jpoly.cubic_roots(*(jnp.asarray(v) for v in (a, b, c, d)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minimize_alpha_poly_matches_reference(d, seed):
    """Quartic objectives of real residuals: the same fp32 coefficients
    give the same constrained argmin."""
    ap = jpoly.newton_schulz_residual(d)
    lo, hi = JPrism(degree=d).bounds
    R = _residuals(seed, (16,), 24)
    t = np.asarray(jsketch.exact_power_traces(jnp.asarray(R),
                                              jpoly.max_trace_power(ap)))
    W = jpoly.trace_weight_matrix(ap).astype(np.float32)
    coeffs = (t @ W.T).astype(np.float32)
    want = jpoly.minimize_alpha_poly(jnp.asarray(coeffs), lo, hi)
    got = poly.minimize_alpha_poly(_t(coeffs), lo, hi)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K", [3, 5, 7])
def test_minimizers_match_reference_on_random_polynomials(K):
    """Degenerate leading coefficients (K = 3: linear derivative) and the
    grid scan of degree > 4 (K = 7) too."""
    rng = np.random.default_rng(K)
    coeffs = rng.standard_normal((32, K)).astype(np.float32)
    coeffs[:, -1] = np.abs(coeffs[:, -1]) + 0.5  # bounded below
    want = jpoly.minimize_alpha_poly(jnp.asarray(coeffs), 0.375, 1.45)
    got = poly.minimize_alpha_poly(_t(coeffs), 0.375, 1.45)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the fit

@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("padded", [False, True])
def test_fit_alpha_from_traces_matches_reference(d, padded):
    """The same fp32 traces (and sketch, for the pad correction) give the
    same alpha and certificate."""
    ap, jap = poly.newton_schulz_residual(d), jpoly.newton_schulz_residual(d)
    lo, hi = JPrism(degree=d).bounds
    n = 24
    key = jax.random.PRNGKey(11)
    S = jsketch.gaussian_sketch(key, 8, n)
    R = jnp.asarray(_residuals(3, (6,), n))
    if padded:  # zero-padded slices: R = diag(R_real, I_pad)
        n_real = np.array([24, 20, 16, 24, 12, 20], np.int32)
        mask = np.arange(n)[None, :] < n_real[:, None]
        m2 = mask[:, :, None] & mask[:, None, :]
        R = jnp.where(m2, R, jnp.eye(n))
    t = jsketch.sketched_power_traces(R, S, jpoly.max_trace_power(jap))
    kw = dict(S=S, n_real=jnp.asarray(n_real)) if padded else {}
    wa, we = jprism.fit_alpha_from_traces(t, jap, lo, hi, return_est_r=True,
                                          **kw)
    tkw = dict(S=_t(S), n_real=torch.tensor(n_real)) if padded else {}
    ga, ge = prism.fit_alpha_from_traces(_t(t), ap, lo, hi,
                                         return_est_r=True, **tkw)
    assert ga.dtype == torch.float32 and tuple(ga.shape) == (6,)
    np.testing.assert_allclose(_np(ga), _np(wa), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ge), _np(we), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sketched", [False, True])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_fit_alpha_matches_reference(dtype, sketched, use_kernels):
    jap = jpoly.newton_schulz_residual(1)
    ap = poly.newton_schulz_residual(1)
    R = _residuals(4, (5,), 32)
    key = jax.random.PRNGKey(2) if sketched else None
    wa, we = jprism.fit_alpha(jnp.asarray(R, jnp.dtype(dtype)), jap, 0.5,
                              1.0, key=key, use_kernels=use_kernels,
                              return_est_r=True)
    ga, ge = prism.fit_alpha(_t(R, dtype), ap, 0.5, 1.0,
                             key=JaxKey(key) if sketched else None,
                             use_kernels=use_kernels, return_est_r=True)
    tol = 1e-5 if dtype == "float32" else TRACE_TOL[dtype]
    np.testing.assert_allclose(_np(ga), _np(wa), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(ge), _np(we), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_traces_and_objective_match_reference(dtype):
    R = _residuals(5, (3,), 20)
    jR, tR = jnp.asarray(R, jnp.dtype(dtype)), _t(R, dtype)
    np.testing.assert_allclose(
        _np(sketch.exact_power_traces(tR, 6)),
        _np(jsketch.exact_power_traces(jR, 6)),
        rtol=TRACE_TOL[dtype], atol=TRACE_TOL[dtype])
    S = jsketch.gaussian_sketch(jax.random.PRNGKey(4), 8, 20,
                                dtype=jnp.dtype(dtype))
    np.testing.assert_allclose(
        _np(sketch.sketched_power_traces(tR, _t(S, dtype), 6)),
        _np(jsketch.sketched_power_traces(jR, S, 6)),
        rtol=TRACE_TOL[dtype], atol=TRACE_TOL[dtype])
    ap, jap = poly.newton_schulz_residual(1), jpoly.newton_schulz_residual(1)
    np.testing.assert_allclose(
        _np(prism.objective_value(_t(R), ap, 0.8)),
        _np(jprism.objective_value(jnp.asarray(R), jap, 0.8)), rtol=1e-5)


def test_exact_fit_with_n_real_matches_reference():
    jap, ap = jpoly.newton_schulz_residual(2), poly.newton_schulz_residual(2)
    R = _residuals(6, (3,), 16)
    n_real = np.array([16, 12, 9], np.int32)
    mask = np.arange(16)[None, :] < n_real[:, None]
    R = np.where(mask[:, :, None] & mask[:, None, :], R,
                 np.eye(16, dtype=np.float32)).astype(np.float32)
    want = jprism.fit_alpha(jnp.asarray(R), jap, 0.375, 1.45,
                            n_real=jnp.asarray(n_real))
    got = prism.fit_alpha(_t(R), ap, 0.375, 1.45,
                          n_real=torch.tensor(n_real))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------- adaptive loop (§11/§15)

def _acfg(cls, tol, dtype="float32", iters=14, warm=1, **kw):
    return cls(degree=2, iterations=iters, warm_alpha_iters=warm,
               sketch_dim=8, dtype=dtype, tol=tol, **kw)


def _mixed_batch():
    key = jax.random.PRNGKey(0)
    conds = [1e-1, 1e-3, 1e-5, 1e-2]
    return np.stack([np.asarray(rm.log_uniform_spectrum(
        jax.random.fold_in(key, i), 32, 32, c)) for i, c in enumerate(conds)])


@pytest.mark.parametrize("tier", ["plain", "grid", "fused"])
def test_adaptive_iters_and_status_match_reference(tier):
    """A mixed-conditioning batch: the same per-slice iteration counts and
    guardian codes as the reference, and the same polar factors."""
    A = _mixed_batch()
    key = jax.random.PRNGKey(0)
    kw = {} if tier == "plain" else dict(use_kernels=True,
                                         fuse="on" if tier == "fused"
                                         else "off")
    jX, jit, jst = jmatfn.polar(jnp.asarray(A), method="prism",
                                cfg=_acfg(JPrism, 2e-2, **kw), key=key,
                                return_iters=True, return_status=True)
    X, it, st = matfn.polar(_t(A), method="prism",
                            cfg=_acfg(PrismConfig, 2e-2, **kw),
                            key=JaxKey(key), return_iters=True,
                            return_status=True)
    assert it.dtype == torch.int32 and st.dtype == torch.int8
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert len(set(it.tolist())) > 1  # the slices stop at different counts
    np.testing.assert_allclose(_np(X), _np(jX), rtol=CHAIN_TOL,
                               atol=CHAIN_TOL)


def test_forced_divergence_quarantines_and_rolls_back():
    """alpha pinned to 50 makes the first fitted step explode: the slice is
    quarantined (status 2) and handed back as the iterate before that
    step — exactly the warm iteration's output — as in the reference."""
    key = jax.random.PRNGKey(0)
    A = np.asarray(rm.log_uniform_spectrum(key, 32, 32, 1e-2))
    cfg = _acfg(PrismConfig, 1e-6, iters=8, alpha_bounds=(50.0, 50.0))
    X, it, st = matfn.polar(_t(A), method="prism", cfg=cfg, key=JaxKey(key),
                            return_iters=True, return_status=True)
    jX, jit, jst = jmatfn.polar(jnp.asarray(A), method="prism",
                                cfg=_acfg(JPrism, 1e-6, iters=8,
                                          alpha_bounds=(50.0, 50.0)),
                                key=key, return_iters=True,
                                return_status=True)
    assert int(st) == int(jst) == prism.STATUS_QUARANTINED
    assert int(it) == int(jit) == 2
    assert bool(torch.isfinite(X).all())
    warm_only = matfn.polar(_t(A), method="prism", cfg=cfg, iters=1)
    torch.testing.assert_close(X, warm_only, rtol=0, atol=0)
    np.testing.assert_allclose(_np(X), _np(jX), rtol=CHAIN_TOL,
                               atol=CHAIN_TOL)


def test_quarantine_is_per_slice():
    key = jax.random.PRNGKey(0)
    good = np.asarray(rm.log_uniform_spectrum(key, 32, 32, 1e-1))
    A = np.stack([good, np.zeros((32, 32), np.float32)])
    X, _, st = matfn.polar(_t(A), method="prism",
                           cfg=_acfg(PrismConfig, 1e-2), key=JaxKey(key),
                           return_iters=True, return_status=True)
    assert int(st[0]) == prism.STATUS_OK and int(st[1]) != prism.STATUS_OK
    assert bool(torch.isfinite(X).all())
    G = X[0].T @ X[0]
    assert float(torch.linalg.matrix_norm(torch.eye(32) - G)) < 5e-2


@pytest.mark.parametrize("tier", ["plain", "fused"])
def test_tol_none_bit_matches_never_certifying_adaptive(tier):
    """tol=None runs the fitted iterations unrolled; an adaptive run whose
    tol never certifies applies the same updates with the same sketches,
    held at the reference test's bound (tests/test_adaptive_tol.py)."""
    key = jax.random.PRNGKey(0)
    A = _t(rm.log_uniform_spectrum(key, 32, 32, 1e-4))
    kw = {} if tier == "plain" else dict(use_kernels=True, fuse="on")
    X_static = matfn.polar(A, cfg=_acfg(PrismConfig, None, iters=4, **kw),
                           key=JaxKey(key))
    X_adapt, used = matfn.polar(A, cfg=_acfg(PrismConfig, 1e-30, iters=4,
                                             **kw),
                                key=JaxKey(key), return_iters=True)
    assert int(used) == 4
    np.testing.assert_allclose(X_static.numpy(), X_adapt.numpy(), rtol=0,
                               atol=1e-6)


# ------------------------------------------------- launch contracts (CPU)

OPS = ("matmul_add", "gram", "sketch_traces", "residual_chain", "apply_g",
       "warm_tail")


def _count_ops(monkeypatch, fn):
    """Calls of each ``ops`` wrapper that ``fn()`` makes: on the card each
    is one kernel launch (the reference's ``count_launches`` counts its
    kernel wrappers the same way)."""
    counts = dict.fromkeys(OPS, 0)
    for name in OPS:
        real = getattr(ops, name)

        def counting(*a, _name=name, _real=real, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, counting)
    out = fn()
    monkeypatch.undo()
    return counts, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("tol", [None, 1e-2])
@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("degree", [1, 2])
def test_launch_contract_per_runtime_iteration(monkeypatch, dtype, B, tol,
                                               fuse, degree):
    """Per fitted iteration 2+d launches on the grid tier (K2, the chain,
    d K1) and 2 on the fused tier (K6, K7); a warm tail is one launch on
    the fused tier and 1+d per iteration on the grid tier — independent
    of tol, B and dtype."""
    A = _t(np.random.default_rng(B).standard_normal((B, 48, 24)), dtype)
    cfg = PrismConfig(degree=degree, iterations=6, warm_alpha_iters=2,
                      sketch_dim=8, dtype=dtype, tol=tol, use_kernels=True,
                      fuse=fuse)
    counts, (_, used, status) = _count_ops(monkeypatch, lambda: matfn.polar(
        A, cfg=cfg, key=Key(3), return_iters=True, return_status=True))
    # runtime fitted iterations: the budget of 4, or, when every slice
    # certified, one past the slowest slice's applied updates (the
    # iteration that certified it still ran)
    fitted = 4
    if tol is not None and not bool((status == prism.STATUS_MAXITER).any()):
        fitted = min(4, int(used.max()) - 2 + 1)
    assert 1 <= fitted <= 4
    if fuse == "on":
        want = dict(warm_tail=1, residual_chain=fitted, apply_g=fitted)
    else:
        want = dict(gram=2 + fitted, sketch_traces=fitted,
                    matmul_add=degree * (2 + fitted))
    assert counts == dict(dict.fromkeys(OPS, 0), **want)


def test_fused_tier_turns_off_for_return_info():
    cfg = PrismConfig(degree=1, iterations=5, warm_alpha_iters=3,
                      use_kernels=True, fuse="on")
    assert newton_schulz._fused_tier(cfg, (64, 16))
    assert not newton_schulz._fused_tier(cfg, (64, 16), return_info=True)
