"""The port's kernel layer on the CPU: the plain versions against the
reference oracles (``repro.kernels.ref``), device dispatch, launch
counters and the Hopper shared-memory model of the fused tier.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there); on the CPU every ``ops`` wrapper
takes the plain version, which is what these tests hold against JAX.
Tolerances are the reference tests' for the same comparison:
matmul_add / gram 2e-5 (fp32) and 2e-2 (bf16), tests/test_kernels.py;
warm_tail 2e-4 and 5e-2, tests/test_fused_iter.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.config import PrismConfig
from repro_torch.core import newton_schulz as tns
from repro_torch.kernels import _build, fused_iter, gram, matmul_add, ops

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

    def run():
        ops.matmul_add(x, r, x, alpha=1.5, beta=0.5)
        ops.gram(x)
        ops.warm_tail(x, (1.45,) * 3, degree=2)

    ops.reset_launches()
    assert ops.count_launches(run) == {"matmul_add": 0, "gram_upper": 0,
                                       "warm_tail": 0}
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


@pytest.mark.parametrize("launch", [
    lambda x: matmul_add.matmul_add(x, x.transpose(1, 2).contiguous()),
    lambda x: gram.gram_upper(x),
    lambda x: fused_iter.warm_tail(x, (1.45,), coeffs=COEFFS),
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
    need = ops.fused_smem_bytes((64, 16), dtype)
    item = 4 if dtype == "float32" else 2
    assert need == 2 * 64 * 16 * item + 16 * 16 * item + 4 * 64 * 16
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
