"""K5 ``sketch_chain``'s layout on the CPU: the split of R's rows over the
blocks of a thread-block cluster and over their warps, the lane each
reduce-scattered sum lands on, the shared-memory footprint and the
choice between K5 and K4's loop.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain version there and ``tools/chip_mutants.py`` breaks it on purpose);
these tests keep the Python mirror of its layout honest: the constants
are read from ``csrc/sketch_chain.cu`` and the index arithmetic is
replayed in numpy.  The plain chain's parity with the JAX reference is in
``test_torch_kernels.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import ops, sketch_traces

CU = (Path(sketch_traces.__file__).resolve().parent / "csrc" /
      "sketch_chain.cu").read_text()
CLUSTERS = [4, 8, 16]  # cluster sizes tools/chain_probe.py builds


def _cu_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def test_layout_constants_mirror_the_kernel_source():
    assert sketch_traces.CHAIN_CLUSTER == _cu_const("CLUSTER")
    assert sketch_traces.CHAIN_THREADS == _cu_const("THREADS")
    assert sketch_traces.CHAIN_STAGES == _cu_const("STAGES")
    assert sketch_traces.CHAIN_GROUP_SUMS == _cu_const("GROUP_SUMS")
    assert sketch_traces.CHAIN_WARPS == sketch_traces.CHAIN_THREADS // 32
    assert sketch_traces.CHAIN_CLUSTER in CLUSTERS


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_every_row_has_exactly_one_rank(cluster):
    """Ranks own contiguous ranges in rank order, ceil(n / cluster) rows
    at most; ranks past n own none (n < cluster included)."""
    for n in range(1, 301):
        split = sketch_traces.chain_row_split(n, cluster)
        assert len(split) == cluster
        owner = np.zeros(n, dtype=int)
        end = 0
        for r0, rows in split:
            assert rows >= 0 and r0 == end
            assert rows <= -(-n // cluster)
            owner[r0:r0 + rows] += 1
            end = r0 + rows
        assert end == n
        assert np.all(owner == 1)
        if n < cluster:
            assert [rows for _, rows in split] == [1] * n + [0] * (cluster - n)


def _warp_rows(rows: int, p: int):
    """The kernel's split of a rank's rows: a warp carries groups of
    ``chain_rows_a_warp(p)`` rows, warp w the groups w, w + WARPS, ..."""
    per = sketch_traces.chain_rows_a_warp(p)
    warps = sketch_traces.CHAIN_WARPS
    groups = -(-rows // per)
    out = []
    for w in range(warps):
        my_groups = -(-(groups - w) // warps) if w < groups else 0
        for g in range(my_groups):
            row0 = (w + warps * g) * per
            out += [row0 + j for j in range(per) if row0 + j < rows]
    return out


@pytest.mark.parametrize("p", [1, 8, 9, 16])
def test_every_row_of_a_rank_has_exactly_one_warp(p):
    for rows in range(0, 130):
        assert sorted(_warp_rows(rows, p)) == list(range(rows))


@pytest.mark.parametrize("per_lane", [1, 2])
def test_reduce_scatter_leaves_each_lane_its_own_sums(per_lane):
    """The kernel's reduce-scatter, replayed: each step a lane keeps the
    half of its values that its lane bit selects and adds its partner's
    copy of that half; lane L ends with the warp's sums of indices
    L * per_lane .. L * per_lane + per_lane - 1."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((32, 32 * per_lane)).astype(np.float32)
    want = v.sum(axis=0, dtype=np.float64)
    lanes = np.arange(32)
    off = 16
    while off >= 1:
        half = off * per_lane
        upper = (lanes & off) != 0
        send = np.where(upper[:, None], v[:, :half], v[:, half:2 * half])
        keep = np.where(upper[:, None], v[:, half:2 * half], v[:, :half])
        v = keep + send[lanes ^ off]
        off //= 2
    got = v[:, :per_lane].reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _footprint(n, p, item):
    """csrc/sketch_chain.cu's layout, written out: V_{i-1} and V_i as
    [w][n] (w = 8 or 16, the register tile's width), the R ring (2 slots,
    16 bytes a row a thread), St at the rank's ceil(n / 16) rows, the
    warps' partials and the ranks' partials of two powers."""
    a16 = lambda b: -(-b // 16) * 16  # noqa: E731
    width = 8 if p <= 8 else 16
    rows_a_warp = 64 // width
    return (2 * a16(width * n * item) + 2 * rows_a_warp * 16 * 256
            + a16(-(-n // 16) * p * item) + 4 * (8 + 2 * 16))


@pytest.mark.parametrize("n,p,item", [(1024, 8, 4), (1024, 8, 2),
                                      (1024, 16, 4), (300, 5, 4),
                                      (37, 12, 2), (5, 1, 4), (1, 1, 2),
                                      (4096, 8, 2)])
def test_footprint_is_the_layout(n, p, item):
    assert sketch_traces.chain_smem_bytes(n, p, item) == _footprint(n, p,
                                                                      item)


def test_footprint_of_the_main_path():
    """[1024, 1024] with an 8-row sketch in fp32: 133,280 bytes, above the
    13 KB the fused tier's bias view needs (so a budget just below it
    moves the grid chains to K4 and leaves the bias buckets fused)."""
    need = sketch_traces.chain_smem_bytes(1024, 8, 4)
    assert need == 133_280
    assert ops.fused_smem_bytes((64, 16), "float32") < need - 16
    assert ops.fused_fits((64, 16), "float32", budget=need - 16)


@pytest.mark.parametrize("n,p,dtype", [(1024, 8, "float32"),
                                       (1024, 16, "float32"),
                                       (1024, 8, "bfloat16"),
                                       (300, 5, "float32"),
                                       (37, 12, "bfloat16")])
def test_chain_fits_at_the_budget_boundary(n, p, dtype):
    item = 4 if dtype == "float32" else 2
    need = sketch_traces.chain_smem_bytes(n, p, item)
    assert ops.chain_fits(n, p, dtype)
    assert ops.chain_fits(n, p, dtype, budget=need)
    assert not ops.chain_fits(n, p, dtype, budget=need - 1)
    # a budget above the card's per-block maximum does not raise it
    assert ops.chain_fits(n, p, dtype, budget=10 * need) is (
        need <= sketch_traces.MAX_SMEM_BYTES)
