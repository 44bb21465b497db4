"""The sign and coupled sqrt families of the port's fused kernels on the
CPU: the plain versions (``repro_torch.kernels.ref``, what ``ops`` runs on
CPU tensors and what ``chip_smoke.py`` holds K3/K6/K7 against on the card)
against the reference oracles (``repro.kernels.ref``), the shared-memory
model of the coupled family, and the launchers' refusals.

Inputs are symmetric (the reference tests' own, ``tests/test_fused_iter.py``)
and also non-symmetric and independent, where X^T X != X X and
Y X != X Y: a residual with the operands mixed up shows only there.
Tolerances: 2e-4 (fp32) and 5e-2 (bf16), tests/test_fused_iter.py::_tol.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, fused_iter, ops, ref

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _coeffs(degree):
    return ops._gd_coeffs(degree)


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a, dtype=jnp.dtype(dtype)),
            torch.tensor(a).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _inputs(kind, B, n, seed):
    """(X, Y) float32: "sym" — the reference tests' symmetric X and Y = I;
    "nonsym" — independent non-symmetric X and Y, entries N(0, 0.5/sqrt(n))
    (spectral radius ~0.5)."""
    rng = np.random.default_rng(seed)
    if kind == "sym":
        a = rng.standard_normal((B, n, n)) / 8.0
        x = 0.5 * (a + np.swapaxes(a, -1, -2))
        y = np.broadcast_to(np.eye(n), (B, n, n))
    else:
        x = rng.standard_normal((B, n, n)) * 0.5 / np.sqrt(n)
        y = rng.standard_normal((B, n, n)) * 0.5 / np.sqrt(n)
    return x.astype(np.float32), np.ascontiguousarray(y, np.float32)


@pytest.mark.parametrize("family", ["sign", "sqrt"])
@pytest.mark.parametrize("kind", ["sym", "nonsym"])
@pytest.mark.parametrize("n", [16, 45])
@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_matches_reference(family, kind, n, dtype):
    x, y = _inputs(kind, 3, n, n)
    jx, tx = _pair(x, dtype)
    jy, ty = _pair(y, dtype) if family == "sqrt" else (None, None)
    want = jref._residual(jx, jy, family=family)
    got = ref._residual(tx, ty, family=family)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    if family == "sqrt":
        assert torch.equal(got, got.transpose(-1, -2))


def test_residuals_see_operand_order():
    """On non-symmetric, independent inputs the sign residual is not the
    polar one and the sqrt residual is not sym(I - X Y): a check on these
    inputs can tell them apart."""
    x, y = (torch.tensor(a) for a in _inputs("nonsym", 2, 32, 1))
    sign = ref._residual(x, family="sign")
    assert float((sign - ref._residual(x, family="polar")).abs().max()) > 0.1
    sq = ref._residual(x, y, family="sqrt")
    swapped = ref._residual(y, x, family="sqrt")  # sym(I - X Y)
    assert float((sq - swapped).abs().max()) > 0.01
    assert float((sq - (torch.eye(32) - y @ x)).abs().max()) > 0.01


@pytest.mark.parametrize("family", ["sign", "sqrt"])
@pytest.mark.parametrize("kind", ["sym", "nonsym"])
@pytest.mark.parametrize("n,maxp", [(16, 5), (37, 10)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_chain_matches_reference(family, kind, n, maxp, dtype):
    x, y = _inputs(kind, 2, n, 3 + n)
    s = (np.random.default_rng(n).standard_normal((8, n)) /
         np.sqrt(8)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jy, ty = _pair(y, dtype) if family == "sqrt" else (None, None)
    js, ts = _pair(s, dtype)
    jR, jt = jref.residual_chain(jx, js, maxp, family=family, Y=jy)
    R, t = ops.residual_chain(tx, ts, maxp, family=family, Y=ty)
    _close(R, jR, dtype)
    assert t.dtype == torch.float32 and tuple(t.shape) == (2, maxp + 1)
    _close(t[..., 1:], jt, dtype)


@pytest.mark.parametrize("kind", ["sym", "nonsym"])
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_g_coupled_matches_reference(kind, degree, dtype):
    """X g_d(R; a) on the right and g_d(R; a) Y on the left, per-slice fp32
    alphas; R not symmetric in the "nonsym" case."""
    x, y = _inputs(kind, 3, 45, degree)
    rng = np.random.default_rng(9 + degree)
    r = (rng.standard_normal((3, 45, 45)) / 12.0).astype(np.float32)
    if kind == "sym":
        r = 0.5 * (r + np.swapaxes(r, -1, -2))
    a = rng.uniform(0.4, 1.45, 3).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jy, ty = _pair(y, dtype)
    jr, tr = _pair(r, dtype)
    wx, wy = jref.apply_g(jx, jr, jnp.asarray(a), coeffs=_coeffs(degree),
                          Y=jy)
    gx, gy = ops.apply_g(tx, tr, torch.tensor(a), degree=degree, Y=ty)
    _close(gx, wx, dtype)
    _close(gy, wy, dtype)
    if kind == "nonsym":  # Y g(R) is not g(R) Y: the sides show
        right = ref._horner(ty, tr, torch.tensor(a)[:, None, None],
                            _coeffs(degree), "right")
        assert float((right.float() - gy.float()).abs().max()) > 0.01


@pytest.mark.parametrize("family", ["sign", "sqrt"])
@pytest.mark.parametrize("kind,alphas", [  # three iterations on independent
    ("sym", (1.45,)), ("sym", (1.45, 1.2, 0.9)),  # inputs leave unit scale
    ("nonsym", (1.45,))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_warm_tail_matches_reference(family, kind, alphas, dtype):
    x, y = _inputs(kind, 3, 23, len(alphas))
    if kind == "sym" and family == "sqrt":
        x = (x @ np.swapaxes(x, -1, -2) + 0.4 * np.eye(23)).astype(
            np.float32)
    jx, tx = _pair(x, dtype)
    jy, ty = _pair(y, dtype) if family == "sqrt" else (None, None)
    want = jref.warm_tail(jx, alphas, coeffs=_coeffs(2), family=family,
                          Y=jy)
    got = ops.warm_tail(tx, alphas, degree=2, family=family, Y=ty)
    if family == "sqrt":
        for g, w in zip(got, want):
            _close(g, w, dtype)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype,limit", [("float32", 107),
                                         ("bfloat16", 138)])
def test_coupled_footprint_and_limit(dtype, limit):
    """The coupled fused kernels hold X, Y, R, the rounded operand and the
    fp32 accumulator (K3 pads its rows to n + 1): [64, 64] fits, the
    limit is the largest n that does, [1024, 1024] takes the grid tier;
    the model is the largest of K3, K6 and K7's coupled footprints.  K6
    and K7 keep their operands with rows of ``tile_pitch`` (K6: X, Y, R,
    and St and two V buffers [n, 8], two partials a warp, the fp32
    residual [n, n + 1]; K7 at its largest share, the whole slice: R, X or
    Y and two Horner operands); K6 dominates a [16, 16] slice, K3 the
    larger ones."""
    item = 4 if dtype == "float32" else 2
    a16 = fused_iter._align16
    for n in (16, 64, limit):
        ld = fused_iter.tile_pitch(n)
        k3 = 4 * a16(n * n * item) + 4 * n * (n + 1)
        assert fused_iter.smem_bytes(n, n, item, coupled=True) == k3
        k6 = fused_iter.residual_chain_smem_bytes(n, n, 8, item, True)
        ldp = fused_iter.tile_pitch(8)
        assert k6 == 3 * a16(n * ld * item) + 3 * a16(n * ldp * item) + \
            8 * fused_iter.RC_WARPS + 4 * n * (n + 1)
        k7 = fused_iter.apply_g_smem_bytes(n, n, item, coupled=True)
        assert k7 == 4 * a16(n * ld * item)
        assert ops.fused_smem_bytes((n, n), dtype, coupled=True) == \
            max(k3, k6, k7) == (k6 if n == 16 else k3)
        assert ops.fused_fits((n, n), dtype, coupled=True)
    assert not ops.fused_fits((limit + 1, limit + 1), dtype, coupled=True)
    assert not ops.fused_fits((1024, 1024), dtype, coupled=True)
    # the polar layout is what it was
    assert fused_iter.smem_bytes(64, 16, item) == \
        2 * a16(64 * 16 * item) + a16(16 * 16 * item) + 4 * 64 * 16


def test_cpu_family_calls_count_nothing():
    x, y = (torch.tensor(a) for a in _inputs("sym", 2, 16, 4))
    s = torch.randn(8, 16)

    def run():
        ops.warm_tail(x, (1.45,) * 3, degree=2, family="sign")
        ops.warm_tail(x, (1.45,) * 3, degree=2, family="sqrt", Y=y)
        ops.residual_chain(x, s, 10, family="sqrt", Y=y)
        r, _ = ops.residual_chain(x, s, 10, family="sign")
        ops.apply_g(x, r, torch.ones(2), degree=2, Y=y)

    assert ops.count_launches(run) == dict.fromkeys(_build.KERNELS, 0)


@pytest.mark.parametrize("launch", [
    lambda x: fused_iter.warm_tail(x, (1.45,), coeffs=(1.0, 0.5),
                                   family="sign"),
    lambda x: fused_iter.warm_tail(x, (1.45,), coeffs=(1.0, 0.5),
                                   family="sqrt", Y=x),
    lambda x: fused_iter.residual_chain(x, x[0, :, :8].contiguous(), 6,
                                        family="sqrt", Y=x),
    lambda x: fused_iter.apply_g(x, x, torch.ones(1), coeffs=(1.0, 0.5),
                                 Y=x),
])
def test_family_launchers_refuse_cpu_tensors(launch):
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(1, 16, 16))


def test_family_arguments_are_checked():
    x = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError, match="sqrt family takes Y"):
        fused_iter._family_code("warm_tail", "sqrt", None, x)
    with pytest.raises(ValueError, match="sqrt family takes Y"):
        fused_iter._family_code("warm_tail", "sign", x, x)
    with pytest.raises(ValueError, match="square"):
        fused_iter._family_code("warm_tail", "sign", None,
                                torch.zeros(1, 16, 8))
    with pytest.raises(ValueError, match="unknown family"):
        fused_iter._family_code("warm_tail", "cube", None, x)
    assert [fused_iter._family_code("k", f, x if f == "sqrt" else None, x)
            for f in fused_iter.FAMILIES] == [0, 1, 2]
