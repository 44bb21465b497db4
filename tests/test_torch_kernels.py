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
import torch_threads  # noqa: F401  (the worker's share of the cores)

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
    operands, rows of ``tile_pitch(16)`` = 20), which K3's block equals
    (the same four operands, rows of ``warm_pitch(16)`` = 20)."""
    need = ops.fused_smem_bytes((64, 16), dtype)
    item = 4 if dtype == "float32" else 2
    k3 = 3 * 64 * 20 * item + 16 * 20 * item
    k7 = 16 * 20 * item + 3 * 64 * 20 * item
    assert fused_iter.smem_bytes(64, 16, item) == k3
    assert need == k7 == k3
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
    buffers beside R, and K3's, which hold the same (one-sided families:
    K3 is never larger than K7)."""
    k3 = fused_iter.smem_bytes(16, 16, 4)
    k6 = fused_iter.residual_chain_smem_bytes(16, 16, 16, 4)
    k7 = fused_iter.apply_g_smem_bytes(16, 16, 4)
    assert k6 > k7 == k3
    assert ops.fused_smem_bytes((16, 16), "float32", sketch_dim=16) == k6
    assert ops.fused_smem_bytes((64, 16), "float32", sketch_dim=8) == \
        fused_iter.apply_g_smem_bytes(64, 16, 4) == \
        fused_iter.smem_bytes(64, 16, 4) > \
        fused_iter.residual_chain_smem_bytes(64, 16, 8, 4)
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


# ------------------------------------------------ K3's layout and the tier

def test_warm_tail_layout_mirrors_the_kernel_source():
    """K3's constants and row pitch are the ones ``csrc/warm_tail.cu``
    lays its block out with; the pitch is the smallest multiple of 4 that
    holds a row and whose quarter is odd (adjacent rows in different bank
    groups)."""
    src = (CSRC / "warm_tail.cu").read_text()
    for name, mirror in (("MAX_DEGREE", fused_iter.MAX_DEGREE),
                         ("MAX_ITERS", fused_iter.MAX_WARM_ITERS)):
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert int(got.group(1)) == mirror
    assert "return 4 * (((cols + 3) / 4) | 1);" in src
    for cols in range(1, 300):
        ld = fused_iter.warm_pitch(cols)
        assert ld >= -(-cols // 4) * 4 and ld % 4 == 0 and (ld // 4) % 2
        assert ld - 4 < cols or (ld // 4 - 1) % 2 == 0
        assert ld <= fused_iter.tile_pitch(cols)


def _a16(b):
    return -(-b // 16) * 16


@pytest.mark.parametrize("m,n", [(64, 16), (16, 16), (64, 64), (55, 23),
                                 (107, 107), (145, 145), (3, 5)])
@pytest.mark.parametrize("item", [4, 2])
@pytest.mark.parametrize("coupled", [False, True])
def test_warm_tail_footprint_is_the_layout(m, n, item, coupled):
    """csrc/warm_tail.cu's block, written out: X, two rounded Horner
    operands (the coupled fp32 residual [n, n + 1] over them, padded past
    them where it is larger), R and, coupled, Y, rows of warm_pitch(n)."""
    if coupled and m != n:
        return
    ld = fused_iter.warm_pitch(n)
    op = _a16(m * ld * item)
    horner = max(2 * op, _a16(4 * n * (n + 1)) if coupled else 0)
    want = op + horner + _a16(n * ld * item) + (op if coupled else 0)
    assert fused_iter.smem_bytes(m, n, item, coupled) == want


def _parent_k3_bytes(m, n, item, coupled):
    """The parent design's K3 block: X, one rounded operand, R (and Y),
    unpadded, and the fp32 accumulator [m, n + coupled]."""
    c = int(coupled)
    return 2 * _a16(m * n * item) + (1 + c) * _a16(n * n * item) + \
        4 * m * (n + c)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sketch_dim", [8, 16])
def test_no_fused_slice_of_the_parent_leaves_the_tier(dtype, sketch_dim):
    """Every polar slice and every coupled slice that the parent's model
    (its K3 beside the same K6 and K7) admitted to the fused tier is
    still admitted; a one-sided K3 block is never larger than K7's."""
    item = 4 if dtype == "float32" else 2
    budget = fused_iter.MAX_SMEM_BYTES

    def parent_fits(m, n, coupled):
        need = max(_parent_k3_bytes(m, n, item, coupled),
                   fused_iter.residual_chain_smem_bytes(m, n, sketch_dim,
                                                        item, coupled),
                   fused_iter.apply_g_smem_bytes(m, n, item, coupled))
        return need <= budget

    for n in range(1, 200):
        if parent_fits(n, n, True):
            assert ops.fused_fits((n, n), dtype, sketch_dim=sketch_dim,
                                  coupled=True), n
    for m in range(1, 200, 3):
        for n in range(1, min(m, 130) + 1, 3):
            assert fused_iter.smem_bytes(m, n, item) <= \
                fused_iter.apply_g_smem_bytes(m, n, item)
            if parent_fits(m, n, False):
                assert ops.fused_fits((m, n), dtype, sketch_dim=sketch_dim)


# ------------------------------------------------ the K5 / K4 route

@pytest.mark.parametrize("n,p,dtype,budget,clusters,want", [
    (1024, 8, "float32", 0, 7, "sketch_chain"),
    (1024, 8, "float32", 0, 1, "sketch_chain"),
    # the footprint fits, but the card holds none of K5's clusters
    (1024, 8, "float32", 0, 0, "sketch_step"),
    (300, 5, "bfloat16", 0, 0, "sketch_step"),
    # a budget below K5's block, or n = 4096 in fp32: K4 whatever the card
    (1024, 8, "float32", 1024, 7, "sketch_step"),
    (4096, 8, "float32", 0, 7, "sketch_step"),
    (4096, 8, "bfloat16", 0, 7, "sketch_chain"),
])
def test_chain_route_asks_the_footprint_and_the_card(n, p, dtype, budget,
                                                     clusters, want):
    assert ops.chain_route(n, p, dtype, budget=budget,
                           resident_clusters=clusters) == want


@pytest.mark.parametrize("clusters,budget,want", [(7, 0, "sketch_chain"),
                                                  (0, 0, "sketch_step"),
                                                  (7, 1024, "sketch_step")])
def test_sketch_traces_routes_before_any_launch(monkeypatch, clusters,
                                                budget, want):
    """ops.sketch_traces on (stand-in) CUDA operands: K5 once, or K4 once
    a power, as chain_route picks from the footprint and the cached
    resident-cluster query; the query runs only where K5's block fits, and
    no launch is tried first and replaced."""
    calls = {"sketch_chain": 0, "sketch_step": 0, "query": 0}

    def chain(R, St, max_power):
        calls["sketch_chain"] += 1
        return sketch_traces.plain_chain(R, St, max_power)

    def step(R, V, St):
        calls["sketch_step"] += 1
        return sketch_traces.plain_step(R, V, St)

    def query(R, St):
        calls["query"] += 1
        return clusters

    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(sketch_traces, "sketch_chain", chain)
    monkeypatch.setattr(sketch_traces, "sketch_step", step)
    monkeypatch.setattr(sketch_traces, "resident_clusters", query)
    rng = np.random.default_rng(9)
    r = torch.tensor(_sym(rng, (2,), 64, 16.0))
    s = torch.tensor(rng.standard_normal((8, 64)) / np.sqrt(8),
                     dtype=torch.float32)
    got = ops.sketch_traces(r, s, 6, budget=budget)
    want_t = ref.sketch_traces(r, s, 6)
    torch.testing.assert_close(got, want_t, rtol=2e-4, atol=2e-4)
    assert calls["query"] == (1 if budget == 0 else 0)
    if want == "sketch_chain":
        assert (calls["sketch_chain"], calls["sketch_step"]) == (1, 0)
    else:
        assert (calls["sketch_chain"], calls["sketch_step"]) == (0, 6)


def test_resident_cluster_query_is_cached(monkeypatch):
    """The query runs once per device, n, p, dtype and instantiation."""
    asked = []

    def info(R, St):
        asked.append((tuple(R.shape), St.shape[1], R.dtype))
        return {"active_clusters": 5}

    monkeypatch.setattr(sketch_traces, "chain_launch_info", info)
    monkeypatch.setattr(sketch_traces, "_CLUSTERS", {})
    r = torch.zeros((3, 64, 64))
    st = torch.zeros((64, 8))
    for _ in range(3):
        assert sketch_traces.resident_clusters(r, st) == 5
    sketch_traces.resident_clusters(torch.zeros((5, 64, 64)), st)
    assert len(asked) == 1
    sketch_traces.resident_clusters(r, torch.zeros((64, 16)))
    sketch_traces.resident_clusters(r.to(torch.bfloat16),
                                    st.to(torch.bfloat16))
    assert len(asked) == 3
