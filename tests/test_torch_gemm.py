"""The Python side of the port's GEMM core (K1 ``matmul_add``, K2
``gram_upper``, ``csrc/gemm.cuh``) on the CPU: the choice between the
aligned and the element-by-element instantiation, the dynamic
shared-memory footprint, K2's grid over the upper tiles, and the
wrappers' refusal of operands the kernels do not take.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions there, and asserts that every main-path
shape takes the aligned instantiation); nothing here needs a GPU.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import fused_iter, gram, matmul_add

GEMM_CUH = (Path(matmul_add.__file__).resolve().parent / "csrc" /
            "gemm.cuh").read_text()
DTYPES = [torch.float32, torch.bfloat16]
# per-SM shared memory of the H100 (228 KB), and what the runtime keeps of
# it for each resident block (1 KB)
SM_SMEM_BYTES = 233472
PER_BLOCK_RESERVED = 1024


def _k1_operands(shape, dtype):
    """A [B, m, k], B [B, k, k], C and D [B, m, k], as the main paths give
    them (k = n)."""
    b, m, k = shape
    return (torch.empty((b, m, k), dtype=dtype),
            torch.empty((b, k, k), dtype=dtype),
            torch.empty((b, m, k), dtype=dtype),
            torch.empty((b, m, k), dtype=dtype))


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts one element past 16 bytes."""
    numel = shape[0] * shape[1] * shape[2]
    base = torch.empty(numel + 1, dtype=dtype)
    t = base[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


@pytest.mark.parametrize("shape", [(100, 1024, 1024), (40, 1024, 1024),
                                   (20, 4096, 1024), (30, 64, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_main_path_shapes_take_the_aligned_variant(shape, dtype):
    assert matmul_add.aligned(*_k1_operands(shape, dtype))
    b, m, n = shape
    x = torch.empty(shape, dtype=dtype)
    assert matmul_add.aligned(x, torch.empty((b, n, n), dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_of_55_take_the_unaligned_variant(dtype):
    assert not matmul_add.aligned(*_k1_operands((1, 55, 55), dtype))
    x = torch.empty((1, 55, 55), dtype=dtype)
    assert not matmul_add.aligned(x, torch.empty((1, 55, 55), dtype=dtype))


@pytest.mark.parametrize("dtype,want", [(torch.float32, True),
                                        (torch.bfloat16, False)])
def test_rows_of_300_are_aligned_only_in_fp32(dtype, want):
    """300 fp32 values are 75 chunks of 16 bytes; 300 bf16 values are 37.5."""
    assert matmul_add.aligned(*_k1_operands((1, 1000, 300), dtype)) is want
    x = torch.empty((1, 1000, 300), dtype=dtype)
    assert matmul_add.aligned(x, torch.empty((1, 300, 300),
                                             dtype=dtype)) is want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", [0, 1, 2])
def test_an_operand_off_16_bytes_takes_the_unaligned_variant(dtype, which):
    ops = list(_k1_operands((2, 64, 64), dtype))
    assert matmul_add.aligned(*ops)
    ops[which] = _misaligned(tuple(ops[which].shape), dtype)
    assert not matmul_add.aligned(*ops)
    assert not matmul_add.aligned(_misaligned((2, 64, 64), dtype),
                                  torch.empty((2, 64, 64), dtype=dtype))


def test_an_absent_c_does_not_decide_the_variant():
    a, b, _, d = _k1_operands((2, 64, 64), torch.float32)
    assert matmul_add.aligned(a, b, None, d)


def test_python_constants_mirror_the_core():
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", GEMM_CUH))
    assert int(consts["TILE"]) == matmul_add.TILE == gram.TILE
    assert int(consts["STAGES"]) == matmul_add.STAGES
    assert "STAGE_BYTES = 2 * TILE * 64;" in GEMM_CUH
    assert matmul_add.STAGE_K_BYTES == 64


def test_shared_memory_footprint_fits_two_blocks_a_sm():
    smem = matmul_add.smem_bytes()
    ring = matmul_add.STAGES * 2 * matmul_add.TILE * 64
    assert smem == max(ring, matmul_add.TILE ** 2 * 4) == 65536
    assert smem <= fused_iter.MAX_SMEM_BYTES == 232448
    # __launch_bounds__(256, 2): two resident blocks must fit one SM
    assert 2 * (smem + PER_BLOCK_RESERVED) <= SM_SMEM_BYTES
    # above the 48 KB a launch gets without cudaFuncSetAttribute, which
    # both launchers therefore call
    assert smem > 48 * 1024


@pytest.mark.parametrize("n", [1, 55, 128, 129, 300, 1024, 4096])
def test_gram_grid_covers_each_upper_tile_once(n):
    nb = -(-n // gram.TILE)
    tiles = [gram.unrank(t, n) for t in range(gram.upper_tiles(n))]
    assert len(tiles) == nb * (nb + 1) // 2
    assert sorted(tiles) == [(i, j) for i in range(nb)
                             for j in range(i, nb)]
    assert len(set(tiles)) == len(tiles)


def test_gram_grid_of_the_main_paths():
    """n = 1024: 36 of the 64 tiles of the full product."""
    assert gram.upper_tiles(1024) == 36
    assert gram.unrank(0, 1024) == (0, 0)
    assert gram.unrank(7, 1024) == (0, 7)
    assert gram.unrank(8, 1024) == (1, 1)
    assert gram.unrank(35, 1024) == (7, 7)


class _FakeCuda:
    """Stands in for a CUDA tensor in the wrappers' operand checks, which
    run before anything touches a device."""

    def __init__(self, shape, dtype=torch.float32, device="cuda:0",
                 contiguous=True):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.is_cuda = self.device.type == "cuda"
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous


def _launches():
    """K1 with its second operand as B, and as C."""
    return [lambda a, b: matmul_add.matmul_add(a, b),
            lambda a, b: matmul_add.matmul_add(a, a, b)]


@pytest.mark.parametrize("launch", _launches() + [
    lambda a, b: gram.gram_upper(a)])
def test_wrappers_refuse_cpu_operands(launch):
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(torch.zeros((1, 8, 8)), torch.zeros((1, 8, 8)))


def test_wrappers_refuse_a_cpu_operand_beside_a_cuda_one():
    with pytest.raises(ValueError, match="CUDA tensors"):
        matmul_add.matmul_add(_FakeCuda((1, 8, 8)), torch.zeros((1, 8, 8)))


@pytest.mark.parametrize("launch", _launches())
def test_wrappers_refuse_mixed_devices(launch):
    with pytest.raises(ValueError, match="one device and dtype"):
        launch(_FakeCuda((1, 8, 8)), _FakeCuda((1, 8, 8), device="cuda:1"))


@pytest.mark.parametrize("launch", _launches())
def test_wrappers_refuse_mixed_dtypes(launch):
    with pytest.raises(ValueError, match="one device and dtype"):
        launch(_FakeCuda((1, 8, 8)),
               _FakeCuda((1, 8, 8), dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrappers_refuse_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        matmul_add.matmul_add(_FakeCuda((1, 8, 8), dtype),
                              _FakeCuda((1, 8, 8), dtype))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gram.gram_upper(_FakeCuda((1, 8, 8), dtype))


def test_wrappers_refuse_non_contiguous_operands():
    with pytest.raises(ValueError, match="contiguous"):
        matmul_add.matmul_add(_FakeCuda((1, 8, 8)),
                              _FakeCuda((1, 8, 8), contiguous=False))
    with pytest.raises(ValueError, match="contiguous"):
        gram.gram_upper(_FakeCuda((1, 8, 8), contiguous=False))


def test_wrappers_refuse_operands_that_do_not_chain():
    with pytest.raises(ValueError, match="do not chain"):
        matmul_add.matmul_add(_FakeCuda((1, 8, 8)), _FakeCuda((1, 9, 8)))
    with pytest.raises(ValueError, match="is not"):
        matmul_add.matmul_add(_FakeCuda((1, 8, 8)), _FakeCuda((1, 8, 4)),
                              _FakeCuda((1, 8, 8)))
