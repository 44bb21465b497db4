"""The port's coupled square root, inverse square root and matrix sign
(``repro_torch.core.matfn.sqrtm`` / ``inv_sqrtm`` / ``signm``, through
``newton_schulz``) against ``repro.core.matfn`` on the CPU: warm (Shampoo's
default PRISM-5) and fitted (Fig. 5's PRISM, sketches drawn through
``JaxKey``) chains, the classical Newton-Schulz chain, adaptive ``tol``
with its telemetry, and the ``eigh`` baselines — with ``use_kernels=True``
and the fused tier forced on and off, so that both tiers' accumulation
orders are held; and the launch contracts of the coupled family, counted
by wrapping the ``ops`` entry points.

Tolerances: 2e-4 (fp32) and 5e-2 (bf16) for warm chains, the bound of the
fused warm tail against its oracle (tests/test_fused_iter.py); 5e-3 for
fitted chains (tests/test_kernels.py); 1e-5 for the fp32 eigh baselines
(both packages call LAPACK on the same fp32 input).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import PrismConfig as JPrism
from repro.core import matfn as jmatfn
from repro_torch.config import PrismConfig
from repro_torch.core import matfn, newton_schulz, prism
from repro_torch.core.rng import Key
from repro_torch.kernels import ops
from test_torch_prism import JaxKey

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
FIT_TOL = 5e-3
WARM = dict(degree=2, iterations=3, warm_alpha_iters=3, sketch_dim=8)
FIG5 = dict(degree=2, iterations=5, warm_alpha_iters=0, sketch_dim=8)
CLASSICAL = dict(degree=2, iterations=4, warm_alpha_iters=0)


def _spd(shape, seed, lo=0.1):
    """Symmetric positive definite [..., n, n], eigenvalues in [lo, 1]
    times a scale in [0.5, 4]."""
    rng = np.random.default_rng(seed)
    *lead, n, _ = shape
    q, _ = np.linalg.qr(rng.standard_normal(tuple(lead) + (n, n)))
    lam = rng.uniform(lo, 1.0, tuple(lead) + (1, n))
    scale = rng.uniform(0.5, 4.0, tuple(lead) + (1, 1))
    return (scale * (q * lam) @ np.swapaxes(q, -1, -2)).astype(np.float32)


def _symm(shape, seed):
    """Symmetric [..., n, n] with eigenvalues of both signs, |lambda| in
    [0.2, 1]: sign's domain."""
    rng = np.random.default_rng(seed)
    *lead, n, _ = shape
    q, _ = np.linalg.qr(rng.standard_normal(tuple(lead) + (n, n)))
    lam = rng.uniform(0.2, 1.0, tuple(lead) + (1, n)) * \
        rng.choice([-1.0, 1.0], tuple(lead) + (1, n))
    return ((q * lam) @ np.swapaxes(q, -1, -2)).astype(np.float32)


def _run(fn_name, a, dtype="float32", jkey=None, method="prism",
         in_dtype="float32", **kw):
    """The same call through both packages; returns (port, reference)."""
    jcfg = JPrism(dtype=dtype, use_kernels=True, **kw)
    tcfg = PrismConfig(dtype=dtype, use_kernels=True, **kw)
    ja = jnp.asarray(a, dtype=jnp.dtype(in_dtype))
    ta = torch.tensor(a).to(getattr(torch, in_dtype))
    want = getattr(jmatfn, fn_name)(ja, method=method, cfg=jcfg, key=jkey)
    got = getattr(matfn, fn_name)(ta, method=method, cfg=tcfg,
                                  key=None if jkey is None else JaxKey(jkey))
    return got, want


def _close(got, want, tol):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 64, 64), (40, 40)])
@pytest.mark.parametrize("cfg,method", [(WARM, "prism"),
                                        (CLASSICAL, "newton_schulz")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", ["on", "off"])
def test_sqrtm_matches_reference(shape, cfg, method, dtype, fuse):
    got, want = _run("sqrtm", _spd(shape, sum(shape)), dtype,
                     method=method, fuse=fuse, **cfg)
    assert got[0].dtype == torch.float32
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 48, 48)])
@pytest.mark.parametrize("cfg,method", [(WARM, "prism"),
                                        (CLASSICAL, "newton_schulz")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", ["on", "off"])
def test_signm_matches_reference(shape, cfg, method, dtype, fuse):
    got, want = _run("signm", _symm(shape, sum(shape)), dtype,
                     method=method, fuse=fuse, **cfg)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fitted_sqrtm_matches_reference(fuse, seed):
    """Fig. 5's PRISM (five fitted iterations, sketch 8), the sketches
    drawn from the same key in both packages."""
    a = _spd((3, 32, 32), 10 + seed)
    got, want = _run("sqrtm", a, jkey=jax.random.PRNGKey(seed), fuse=fuse,
                     **FIG5)
    _close(got, want, FIT_TOL)


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_fitted_signm_and_exact_traces_match_reference(fuse):
    a = _symm((2, 24, 24), 3)
    got, want = _run("signm", a, jkey=jax.random.PRNGKey(4), fuse=fuse,
                     **FIG5)
    _close(got, want, FIT_TOL)
    # without a key the fit reads exact traces
    got, want = _run("sqrtm", _spd((2, 24, 24), 5), fuse=fuse, **FIG5)
    _close(got, want, FIT_TOL)


@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("tol", [None, 0.05])
def test_inv_sqrtm_with_telemetry_matches_reference(fuse, tol):
    """inv_sqrtm returns the coupled iteration's Y; with an adaptive tol the
    per-slice iteration counts and statuses are the reference's."""
    a = _spd((4, 32, 32), 7, lo=0.02)
    a[1] = _spd((32, 32), 8, lo=0.5)  # a well-conditioned slice stops early
    kw = dict(FIG5, warm_alpha_iters=1, iterations=6, tol=tol)
    jkey = jax.random.PRNGKey(2)
    want, wit, wst = jmatfn.inv_sqrtm(
        jnp.asarray(a), cfg=JPrism(use_kernels=True, fuse=fuse, **kw),
        key=jkey, return_iters=True, return_status=True)
    got, it, st = matfn.inv_sqrtm(
        torch.tensor(a), cfg=PrismConfig(use_kernels=True, fuse=fuse, **kw),
        key=JaxKey(jkey), return_iters=True, return_status=True)
    _close(got, want, FIT_TOL)
    np.testing.assert_array_equal(it.numpy(), np.asarray(wit))
    np.testing.assert_array_equal(st.numpy(), np.asarray(wst))
    assert it.dtype == torch.int32 and st.dtype == torch.int8
    if tol is not None:
        assert int(it[1]) < int(it.max())
    got1 = matfn.inv_sqrtm(torch.tensor(a),
                           cfg=PrismConfig(use_kernels=True, fuse=fuse,
                                           **kw), key=JaxKey(jkey))
    torch.testing.assert_close(got1, got, rtol=0, atol=0)


def test_return_info_matches_reference():
    a = _spd((2, 16, 16), 9)
    kw = dict(FIG5, warm_alpha_iters=2)
    jkey = jax.random.PRNGKey(6)
    (_, _), winfo = jmatfn.sqrtm(jnp.asarray(a), cfg=JPrism(**kw), key=jkey,
                                 return_info=True)
    (_, _), info = matfn.sqrtm(torch.tensor(a), cfg=PrismConfig(**kw),
                               key=JaxKey(jkey), return_info=True)
    _close(info.alphas, winfo.alphas, 1e-5)
    _close(info.residual_fro, winfo.residual_fro, 1e-4)


@pytest.mark.parametrize("fn", ["sqrtm", "inv_sqrtm", "signm"])
def test_eigh_baselines_match_reference(fn):
    a = _symm((3, 24, 24), 11) if fn == "signm" else _spd((3, 24, 24), 11)
    want = getattr(jmatfn, fn)(jnp.asarray(a), method="eigh")
    got = getattr(matfn, fn)(torch.tensor(a), method="eigh")
    _close(got, want, 1e-5)
    out, it, st = getattr(matfn, fn)(torch.tensor(a), method="eigh",
                                     return_iters=True, return_status=True)
    assert it.tolist() == [0, 0, 0] and st.dtype == torch.int8
    assert not bool(st.any())
    with pytest.raises(ValueError, match="return_info"):
        getattr(matfn, fn)(torch.tensor(a), method="eigh", return_info=True)


@pytest.mark.parametrize("p", [2, 4])
def test_inv_proot_eigh_matches_reference(p):
    a = _spd((2, 20, 20), 12)
    want = jmatfn.inv_proot(jnp.asarray(a), p=p, method="eigh")
    got = matfn.inv_proot(torch.tensor(a), p=p, method="eigh")
    _close(got, want, 1e-5)


def test_unported_methods_raise():
    a = torch.eye(8)
    for fn, method in (("sqrtm", "polar_express"), ("sqrtm", "newton"),
                       ("signm", "polar_express"),
                       ("inv_sqrtm", "inverse_newton")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(matfn, fn)(a, method=method)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        matfn.inv_proot(a, p=2, method="prism")


def test_two_tiers_of_the_sqrt_family_in_bf16():
    """The grid tier rounds Y X, then forms I - (.) and the symmetrization
    in bf16; the fused tier does all three on the fp32 accumulator and
    rounds once.  The two tiers therefore differ in bf16 (they agree in
    fp32 to the warm tolerance); each matches the reference's own tier."""
    a = _spd((3, 32, 32), 13)
    kw = dict(WARM, use_kernels=True)
    x = torch.tensor(a)
    on = matfn.sqrtm(x, cfg=PrismConfig(dtype="bfloat16", fuse="on", **kw))
    off = matfn.sqrtm(x, cfg=PrismConfig(dtype="bfloat16", fuse="off", **kw))
    assert any(not torch.equal(u, v) for u, v in zip(on, off))
    _close(on, tuple(v.float() for v in off), TOL["bfloat16"])
    on32 = matfn.sqrtm(x, cfg=PrismConfig(fuse="on", **kw))
    off32 = matfn.sqrtm(x, cfg=PrismConfig(fuse="off", **kw))
    _close(on32, tuple(v.float() for v in off32), TOL["float32"])


# ------------------------------------------------------------ launches

OPS = ("matmul_add", "gram", "sketch_traces", "warm_tail", "residual_chain",
       "apply_g")


def _count_ops(monkeypatch, fn):
    """Calls of each ``ops`` wrapper that ``fn()`` makes: on the card each
    is one kernel launch."""
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


@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("tol", [None, 0.05])
@pytest.mark.parametrize("B,dtype", [(1, "float32"), (4, "bfloat16")])
def test_coupled_launch_contract(monkeypatch, fuse, degree, tol, B, dtype):
    """The coupled family per runtime iteration: a fused fitted iteration
    is 2 launches (K6, then K7 writing X' and Y'), a fused warm tail 1; a
    grid fitted iteration is 1 + 1 + 2d (Y X, the chain, d Horner GEMMs a
    side) and a grid warm iteration 1 + 2d — whatever B, dtype and tol."""
    a = torch.tensor(_spd((B, 24, 24), B))
    cfg = PrismConfig(degree=degree, iterations=6, warm_alpha_iters=2,
                      sketch_dim=8, dtype=dtype, tol=tol, use_kernels=True,
                      fuse=fuse)
    counts, ((x, y), used, status) = _count_ops(
        monkeypatch, lambda: matfn.sqrtm(a, cfg=cfg, key=Key(3),
                                         return_iters=True,
                                         return_status=True))
    fitted = 4
    if tol is not None and not bool((status == prism.STATUS_MAXITER).any()):
        fitted = min(4, int(used.max()) - 2 + 1)
    assert 1 <= fitted <= 4
    if fuse == "on":
        want = dict(warm_tail=1, residual_chain=fitted, apply_g=fitted)
    else:
        want = dict(matmul_add=(1 + 2 * degree) * (2 + fitted),
                    sketch_traces=fitted)
    assert counts == dict(dict.fromkeys(OPS, 0), **want)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_sign_launch_contract(monkeypatch, fuse):
    """sign: a fused fitted iteration 2 launches, a warm tail 1; a grid
    fitted iteration 1 + 1 + d (X X, the chain, d Horner GEMMs)."""
    a = torch.tensor(_symm((3, 24, 24), 1))
    cfg = PrismConfig(degree=2, iterations=5, warm_alpha_iters=2,
                      sketch_dim=8, use_kernels=True, fuse=fuse)
    counts, _ = _count_ops(monkeypatch,
                           lambda: matfn.signm(a, cfg=cfg, key=Key(1)))
    if fuse == "on":
        want = dict(warm_tail=1, residual_chain=3, apply_g=3)
    else:
        want = dict(matmul_add=3 * 5, sketch_traces=3)
    assert counts == dict(dict.fromkeys(OPS, 0), **want)


def test_fused_tier_of_the_coupled_family():
    """The coupled model decides the tier: [64, 64] fuses, the fp32 limit
    107 fuses, 108 takes the grid tier, and fuse="on" beyond it raises
    instead of launching."""
    cfg = PrismConfig(use_kernels=True)
    assert newton_schulz._fused_tier(cfg, (64, 64), coupled=True)
    assert newton_schulz._fused_tier(cfg, (107, 107), coupled=True)
    assert not newton_schulz._fused_tier(cfg, (108, 108), coupled=True)
    assert newton_schulz._fused_tier(cfg, (108, 108))  # one-sided fits
    with pytest.raises(ValueError, match="pair needs"):
        newton_schulz._fused_tier(PrismConfig(use_kernels=True, fuse="on"),
                                  (108, 108), coupled=True)
