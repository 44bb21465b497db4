"""The port's kernel layer on the CPU: the plain versions against the
reference oracles (``repro.kernels.ref``), device dispatch, launch
counters and the Hopper shared-memory model of the fused tier.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there); on the CPU every ``ops`` wrapper
takes the plain version, which is what these tests hold against JAX.
Tolerances are the reference tests' for the same comparison:
matmul_add / gram 2e-5 (fp32) and 2e-2 (bf16), tests/test_kernels.py;
warm_tail, residual_chain and apply_g 2e-4 and 5e-2,
tests/test_fused_iter.py; the sketched traces 2e-4 and 5e-2,
tests/test_kernels.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import sketch_traces as jsk
from repro_torch.config import PrismConfig
from repro_torch.core import newton_schulz as tns
from repro_torch.kernels import (_build, fused_iter, gram, matmul_add, ops,
                                 ref, sketch_traces)

DTYPES = ["float32", "bfloat16"]
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WARM_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
COEFFS = (1.0, 0.5)  # g_2: ascending Taylor f_0, f_1 of (1-x)^{-1/2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU torch tensor (fp32 -> bf16
    rounds to nearest even in both)."""
    j = jnp.asarray(a, dtype=jnp.dtype(dtype))
    t = torch.tensor(a).to(getattr(torch, dtype))
    return j, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


MM_SHAPES = [  # (batch lead, m, k, n)
    ((), 64, 48, 32),
    ((3,), 55, 55, 55),
    ((2,), 96, 64, 64),
    ((2, 2), 64, 16, 16),
]


@pytest.mark.parametrize("lead,m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_c", [False, True])
def test_matmul_add_plain_matches_reference(lead, m, k, n, dtype, with_c):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(lead + (m, k)).astype(np.float32)
    b = rng.standard_normal(lead + (k, n)).astype(np.float32)
    c = rng.standard_normal(lead + (m, n)).astype(np.float32)
    (ja, ta), (jb, tb), (jc, tc) = (_pair(x, dtype) for x in (a, b, c))
    kw = dict(alpha=0.7, beta=-1.3) if with_c else dict(alpha=2.0)
    want = jref.matmul_add(ja, jb, jc if with_c else None, **kw)
    got = ops.matmul_add(ta, tb, tc if with_c else None, **kw)
    assert got.dtype == ta.dtype and tuple(got.shape) == want.shape
    _close(got, want, KERNEL_TOL[dtype])


@pytest.mark.parametrize("lead,m,n", [((), 64, 48), ((3,), 55, 55),
                                      ((2,), 96, 64), ((2, 2), 64, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_plain_matches_reference(lead, m, n, dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(lead + (m, n)) / np.sqrt(m)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jref.gram(jx, alpha=1.0, beta=-1.0)
    got = ops.gram(tx, alpha=1.0, beta=-1.0)
    assert tuple(got.shape) == want.shape
    _close(got, want, KERNEL_TOL[dtype])
    np.testing.assert_array_equal(got.float().numpy(),
                                  got.transpose(-1, -2).float().numpy())


@pytest.mark.parametrize("lead,m,n", [((), 64, 16), ((3,), 55, 55),
                                      ((2,), 96, 64), ((30,), 64, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("alphas", [(1.45,), (1.45, 1.45, 1.45),
                                    (1.45, 1.2, 0.9)])
def test_warm_tail_plain_matches_reference(lead, m, n, dtype, alphas):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(lead + (m, n))
    # Frobenius-normalized per slice, as newton_schulz.polar feeds it
    x = (x / np.linalg.norm(x, axis=(-2, -1), keepdims=True)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    want = jref.warm_tail(jx, alphas, coeffs=COEFFS, family="polar")
    got = ops.warm_tail(tx, alphas, degree=2)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    _close(got, want, WARM_TOL[dtype])


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 64, 16)), dtype=torch.float32)
    r = torch.eye(16).expand(2, 16, 16)
    s = torch.tensor(rng.standard_normal((8, 16)), dtype=torch.float32)

    def run():
        ops.matmul_add(x, r, x, alpha=1.5, beta=0.5)
        ops.gram(x)
        ops.warm_tail(x, (1.45,) * 3, degree=2)
        ops.sketch_traces(r, s, 6)
        ops.sketch_traces(r, s, 6, budget=1)
        ops.residual_chain(x, s, 6)
        ops.apply_g(x, r, torch.ones(2), degree=1)

    ops.reset_launches()
    assert ops.count_launches(run) == dict.fromkeys(_build.KERNELS, 0)
    assert set(_build.KERNELS) == {"matmul_add", "gram_upper", "warm_tail",
                                   "sketch_step", "sketch_chain",
                                   "residual_chain", "apply_g"}
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def _st(x):
    return x[0, :, :8].contiguous()


@pytest.mark.parametrize("launch", [
    lambda x: matmul_add.matmul_add(x, x.transpose(1, 2).contiguous()),
    lambda x: gram.gram_upper(x),
    lambda x: fused_iter.warm_tail(x, (1.45,), coeffs=COEFFS),
    lambda x: sketch_traces.sketch_chain(x, _st(x), 6),
    lambda x: sketch_traces.chain_launch_info(x, _st(x)),
    lambda x: sketch_traces.sketch_step(x, x[:, :, :8].contiguous(), _st(x)),
    lambda x: fused_iter.residual_chain(x, _st(x), 6),
    lambda x: fused_iter.apply_g(x, x, torch.ones(1), coeffs=COEFFS),
])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    """A kernel wrapper launches or raises; it never computes the plain
    version itself (that choice belongs to ``ops``, by device)."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(torch.zeros((1, 8, 8)))


def test_mixed_devices_are_refused():
    with pytest.raises(ValueError, match="all lie on the CPU"):
        ops._on_cuda(torch.zeros(2), torch.zeros(2, device="meta"))


def test_collapse_flattens_lead_dims_and_broadcasts():
    a = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    b = torch.ones(5, 6)
    ab, bb, cb = ops._collapse((2, 3), a, b, None)
    assert ab.shape == (6, 4, 5) and ab.is_contiguous()
    assert bb.shape == (6, 5, 6) and bb.is_contiguous()
    assert cb is None
    torch.testing.assert_close(ab[4], a[1, 1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_smem_model_admits_the_bias_view(dtype):
    """The bias view's footprint is K7's block at its largest share (the
    whole [64, 16] slice: R and three [64, 16] buffers, X and two Horner
    operands, rows of ``tile_pitch(16)`` = 20) in fp32, and K3's (X, the
    rounded operand, R, the fp32 accumulator) in bf16."""
    need = ops.fused_smem_bytes((64, 16), dtype)
    item = 4 if dtype == "float32" else 2
    k3 = 2 * 64 * 16 * item + 16 * 16 * item + 4 * 64 * 16
    k7 = 16 * 20 * item + 3 * 64 * 20 * item
    assert need == (k7 if dtype == "float32" else k3) == max(k3, k7)
    assert ops.fused_fits((64, 16), dtype)


@pytest.mark.parametrize("mshape", [(1024, 1024), (4096, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_smem_model_rejects_the_grid_views(mshape, dtype):
    assert ops.fused_smem_bytes(mshape, dtype) > ops.DEFAULT_SMEM_BUDGET
    assert not ops.fused_fits(mshape, dtype)


def test_smem_budget_override_and_batch_independence():
    need = ops.fused_smem_bytes((64, 16), "float32")
    assert ops.DEFAULT_SMEM_BUDGET == 232_448
    assert ops.fused_fits((64, 16), "float32", budget=need)
    assert not ops.fused_fits((64, 16), "float32", budget=need - 1)
    # the model reads the matrix shape only, never a batch dim
    assert ops.fused_smem_bytes((30, 64, 16), "float32") == need


@pytest.mark.parametrize("mshape", [(1024, 1024), (4096, 1024)])
def test_fuse_on_over_budget_raises(mshape):
    cfg = PrismConfig(degree=2, iterations=3, warm_alpha_iters=3,
                      use_kernels=True, fuse="on")
    with pytest.raises(ValueError, match="fuse='on'"):
        tns._fused_tier(cfg, mshape)
    small = PrismConfig(degree=2, iterations=3, warm_alpha_iters=3,
                        use_kernels=True, fuse="on", vmem_budget=1024)
    with pytest.raises(ValueError, match="fuse='on'"):
        tns.polar(torch.ones((2, 64, 16)), cfg=small)


# ------------------------------------------------ the fitted iterations' K4-K7

FIT_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _sym(rng, lead, n, scale):
    a = rng.standard_normal(lead + (n, n)) / scale
    return (0.5 * (a + np.swapaxes(a, -1, -2))).astype(np.float32)


@pytest.mark.parametrize("lead,n,p,maxp", [((), 48, 8, 4), ((3,), 64, 8, 10),
                                           ((2,), 37, 5, 6),
                                           ((2, 2), 16, 16, 7)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_traces_plain_matches_reference(lead, n, p, maxp, dtype):
    """ops.sketch_traces (CPU: the plain chain, whichever of K4/K5 the
    budget picks on the card) against the reference oracle."""
    rng = np.random.default_rng(4)
    r = _sym(rng, lead, n, 2 * np.sqrt(n))
    s = (rng.standard_normal((p, n)) / np.sqrt(p)).astype(np.float32)
    (jr, tr), (js, ts) = _pair(r, dtype), _pair(s, dtype)
    want = jref.sketch_traces(jr, js, maxp)
    for budget in (0, 1):
        got = ops.sketch_traces(tr, ts, maxp, budget=budget)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got, want, FIT_TOL[dtype])


@pytest.mark.parametrize("n,p", [(64, 8), (40, 3)])
def test_sketch_step_plain_matches_reference_kernel(n, p):
    """A chain of plain ``sketch_step`` powers against the reference's
    Pallas ``sketch_step`` run in interpret mode (tests/test_kernels.py
    holds it the same way)."""
    rng = np.random.default_rng(5)
    r = _sym(rng, (), n, 2 * np.sqrt(n))
    s = (rng.standard_normal((p, n)) / np.sqrt(p)).astype(np.float32)
    jst = jnp.pad(jnp.asarray(s).T, ((0, 0), (0, (-p) % 128)))
    jv = jst
    st = torch.tensor(s).t().contiguous()
    v = st
    for _ in range(5):
        jv, jt = jsk.sketch_step(jnp.asarray(r), jv, jst, bm=32, bk=32,
                                 interpret=True)
        v, t = sketch_traces.plain_step(torch.tensor(r), v, st)
        _close(t, jt, FIT_TOL["float32"])
        _close(v, jv[:, :p], FIT_TOL["float32"])


@pytest.mark.parametrize("lead,m,n,p,maxp", [((3,), 64, 16, 8, 6),
                                             ((2,), 55, 23, 5, 10),
                                             ((2, 2), 16, 16, 8, 6)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_chain_plain_matches_reference(lead, m, n, p, maxp, dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(lead + (m, n))
    x = (x / np.linalg.norm(x, axis=(-2, -1), keepdims=True)).astype(
        np.float32)
    s = (rng.standard_normal((p, n)) / np.sqrt(p)).astype(np.float32)
    (jx, tx), (js, ts) = _pair(x, dtype), _pair(s, dtype)
    jR, jt = jref.residual_chain(jx, js, maxp)
    R, t = ops.residual_chain(tx, ts, maxp)
    assert R.dtype == tx.dtype and tuple(R.shape) == jR.shape
    _close(R, jR, FIT_TOL[dtype])
    assert tuple(t.shape) == lead + (maxp + 1,)
    _close(t[..., 1:], jt, FIT_TOL[dtype])
    want_t0 = np.sum(np.square(np.asarray(js, np.float32)))
    np.testing.assert_allclose(t[..., 0].numpy(), want_t0, rtol=1e-6)


@pytest.mark.parametrize("lead,m,n", [((3,), 64, 16), ((2,), 55, 23),
                                      ((2, 2), 16, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("degree", [1, 2])
def test_apply_g_plain_matches_reference(lead, m, n, dtype, degree):
    """A different fitted alpha in every slice, read per slice."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(lead + (m, n))
    x = (x / np.linalg.norm(x, axis=(-2, -1), keepdims=True)).astype(
        np.float32)
    r = _sym(rng, lead, n, 2 * np.sqrt(n))
    a = rng.uniform(0.5, 1.45, lead).astype(np.float32)
    (jx, tx), (jr, tr) = _pair(x, dtype), _pair(r, dtype)
    coeffs = ops._gd_coeffs(degree)
    want = jref.apply_g(jx, jr, jnp.asarray(a), coeffs=coeffs)
    got = ops.apply_g(tx, tr, torch.tensor(a), degree=degree)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    _close(got, want, FIT_TOL[dtype])
    # a float alpha broadcasts over the slices
    got = ops.apply_g(tx, tr, 0.75, degree=degree)
    _close(got, jref.apply_g(jx, jr, 0.75, coeffs=coeffs), FIT_TOL[dtype])


@pytest.mark.parametrize("n,dtype,fits", [(1024, "float32", True),
                                          (1024, "bfloat16", True),
                                          (4096, "float32", False),
                                          (4096, "bfloat16", True)])
def test_chain_model_picks_the_whole_chain_kernel_when_it_fits(n, dtype,
                                                               fits):
    """A K5 cluster block keeps both V buffers ([8, n] each), its ring of
    R and St at its rows; at n = 4096 in fp32 they exceed 232,448 bytes
    and the chain loops K4."""
    item = 4 if dtype == "float32" else 2
    need = sketch_traces.chain_smem_bytes(n, 8, item)
    ring = (sketch_traces.CHAIN_STAGES * sketch_traces.chain_rows_a_warp(8)
            * 16 * sketch_traces.CHAIN_THREADS)
    rank_rows = -(-n // sketch_traces.CHAIN_CLUSTER)
    assert need == (2 * 8 * n * item + ring + rank_rows * 8 * item
                    + 4 * (sketch_traces.CHAIN_WARPS
                           + 2 * sketch_traces.CHAIN_CLUSTER))
    assert ops.chain_fits(n, 8, dtype) is fits
    assert ops.chain_fits(n, 8, dtype, budget=need) is fits
    assert not ops.chain_fits(n, 8, dtype, budget=need - 1)


def test_fused_model_is_the_largest_fused_kernel():
    """fused_smem_bytes is the largest of K3, K6 and K7's footprints: at a
    square [16, 16] slice with a 16-row sketch, K6's chain buffers
    dominate; at the polar bias view [64, 16], K7's three pitched [64, 16]
    buffers beside R."""
    k3 = fused_iter.smem_bytes(16, 16, 4)
    k6 = fused_iter.residual_chain_smem_bytes(16, 16, 16, 4)
    k7 = fused_iter.apply_g_smem_bytes(16, 16, 4)
    assert k6 > k7 > k3
    assert ops.fused_smem_bytes((16, 16), "float32", sketch_dim=16) == k6
    assert ops.fused_smem_bytes((64, 16), "float32", sketch_dim=8) == \
        fused_iter.apply_g_smem_bytes(64, 16, 4) > \
        max(fused_iter.smem_bytes(64, 16, 4),
            fused_iter.residual_chain_smem_bytes(64, 16, 8, 4))
    assert ops.fused_fits((16, 16), "float32", budget=k6, sketch_dim=16)
    assert not ops.fused_fits((16, 16), "float32", budget=k6 - 1,
                              sketch_dim=16)


# every bucket of the four main paths: (matrix shape of a slice, coupled,
# fused tier) -- Muon's q/k/v bias view and its two weight buckets,
# Shampoo's bias preconditioners and its 1024-side factor bucket
MAIN_BUCKETS = [((64, 16), False, True), ((16, 16), True, True),
                ((64, 64), True, True), ((1024, 1024), False, False),
                ((1024, 4096), False, False), ((1024, 1024), True, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mshape,coupled,fused", MAIN_BUCKETS)
def test_main_path_buckets_keep_their_tier(mshape, coupled, fused, dtype):
    assert ops.fused_fits(mshape, dtype, sketch_dim=8,
                          coupled=coupled) is fused


CSRC = Path(fused_iter.__file__).parent / "csrc"


def test_fused_layout_constants_mirror_the_kernel_sources():
    threads = re.search(r"constexpr int RC_THREADS = (\d+);",
                        (CSRC / "residual_chain.cu").read_text())
    assert int(threads.group(1)) // 32 == fused_iter.RC_WARPS
    assert "return (cols + 7) / 8 * 8 + 4;" in \
        (CSRC / "tiles.cuh").read_text()
    for cols in range(1, 300):
        ld = fused_iter.tile_pitch(cols)
        # room for a 4-wide chunk at the last column, 4-aligned rows whose
        # quarter is odd (adjacent rows in different bank groups)
        assert ld >= -(-cols // 4) * 4 and ld % 4 == 0 and (ld // 4) % 2


@pytest.mark.parametrize("batch,m,blocks", [(30, 64, 120), (30, 16, 120),
                                            (40, 64, 160), (5, 55, 70),
                                            (1, 3, 1), (200, 64, 200)])
def test_apply_g_split_covers_every_row_once(batch, m, blocks):
    """K7's grid (batch, ceil(m / rows)): rows is a multiple of 4 (or m),
    the main-path buckets of 30 slices take 120 blocks, and the blocks'
    4 x 4 tiles (rows ti + a TI) cover every row of a slice once; a share
    needs no more shared memory than the whole slice (the tier's model)."""
    rows = fused_iter.apply_g_rows(batch, m)
    splits = -(-m // rows)
    assert rows % 4 == 0 or rows == m
    assert batch * splits == blocks
    seen = []
    for s in range(splits):
        r0 = s * rows
        h = min(rows, m - r0)
        ti_count = -(-h // 4)
        seen += [r0 + ti + a * ti_count for ti in range(ti_count)
                 for a in range(4) if ti + a * ti_count < h]
    assert sorted(seen) == list(range(m))
    for n, coupled in ((m, True), (16, False)):
        assert fused_iter.apply_g_smem_bytes(m, n, 4, coupled, rows=rows) \
            <= fused_iter.apply_g_smem_bytes(m, n, 4, coupled)


def test_plain_chain_reads_the_accumulator_before_rounding():
    """The §9 order: in bf16 the trace of a power reduces the fp32
    product, so it differs from the trace of the rounded V'."""
    rng = np.random.default_rng(8)
    r = torch.tensor(_sym(rng, (), 32, 8.0)).to(torch.bfloat16)
    st = torch.tensor(rng.standard_normal((32, 8)) / np.sqrt(8),
                      dtype=torch.float32).to(torch.bfloat16)
    v, t = ref.sketch_step(r, st, st)
    acc = torch.matmul(r.float(), st.float())
    assert float(t) == float(torch.sum(st.float() * acc))
    assert float(t) != float(torch.sum(st.float() * v.float()))
