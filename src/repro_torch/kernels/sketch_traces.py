"""K4 ``sketch_step`` and K5 ``sketch_chain``: the sketched power traces
of PRISM's alpha fit as hand-written CUDA kernels.

Counterpart of ``repro/kernels/sketch_traces.py``.  A fit needs
t_i = tr(S R^i S^T), i = 1..max_power, through the chain V_i = R V_{i-1}
with V_0 = St = S^T ([n, p], shared across the batch).  Each trace is
reduced in fp32 from the fp32 accumulator of R @ V before V' rounds to
the operand dtype (DESIGN.md §9).

  * ``sketch_chain`` (K5, ``csrc/sketch_chain.cu``): the whole chain of a
    [B, n, n] bucket in ONE launch, one block per slice, with St and the
    two V ping-pong buffers in shared memory; R streams from device
    memory once per power.  Its footprint ``chain_smem_bytes`` grows with
    n, so ``ops.sketch_traces`` launches it only when it fits one block.
  * ``sketch_step`` (K4, ``csrc/sketch_step.cu``): one power, a grid over
    (row tile, slice), with a bounded footprint (a k-tile of V in shared
    memory); the fallback loop of ``ops.sketch_traces``.  The trace is a
    sum across blocks, reduced in a fixed order (per-tile partials, then
    the last block of each slice sums them in order), so it is the same
    from run to run.

``sketch`` p may be at most ``MAX_SKETCH``; there is no padding of p.
``plain_chain``/``plain_step`` are the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

MAX_SMEM_BYTES = 232_448
MAX_SKETCH = 16
CHAIN_WARPS = 8    # csrc/chain.cuh CHAIN_THREADS / 32
STEP_ROWS = 32     # rows of R one K4 block covers (8 warps x 4 rows)


def plain_chain(R: torch.Tensor, St: torch.Tensor, max_power: int
                ) -> torch.Tensor:
    """Traces of powers 1..max_power, [B, max_power] fp32."""
    return ref._chain(R, St, max_power)[0]


def plain_step(R: torch.Tensor, V: torch.Tensor, St: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ref.sketch_step(R, V, St)


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def chain_smem_bytes(n: int, p: int, itemsize: int) -> int:
    """Shared memory of one K5 block: St and the two V buffers ([p, n]
    each, operand dtype, 16-byte aligned) plus one fp32 trace partial per
    warp — the layout ``csrc/sketch_chain.cu`` uses."""
    return 3 * _align16(p * n * itemsize) + 4 * CHAIN_WARPS


def _check_sketch(name: str, n: int, St: torch.Tensor) -> int:
    if St.dim() != 2 or St.shape[0] != n:
        raise ValueError(f"{name}: St must be [{n}, p], got "
                         f"{tuple(St.shape)}")
    p = St.shape[1]
    if not 1 <= p <= MAX_SKETCH:
        raise ValueError(f"{name}: sketch dim {p} outside 1..{MAX_SKETCH}")
    return p


_CHAIN_SYMBOL = "prism_sketch_chain"
_CHAIN_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def sketch_chain(R: torch.Tensor, St: torch.Tensor, max_power: int
                 ) -> torch.Tensor:
    """Launch K5 on a contiguous CUDA R [Bt, n, n] and St [n, p] (one
    dtype, fp32 or bf16): fp32 traces [Bt, max_power] of powers
    1..max_power, one launch."""
    _build.check_cuda_operands("sketch_chain", (R,))
    nb, n, n2 = R.shape
    if n != n2:
        raise ValueError(f"sketch_chain: R must be square, got "
                         f"{tuple(R.shape)}")
    _build.check_companion("sketch_chain", R, St)
    p = _check_sketch("sketch_chain", n, St)
    smem = chain_smem_bytes(n, p, R.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"sketch_chain: n={n}, p={p} {R.dtype} needs "
                         f"{smem} bytes of shared memory, more than the "
                         f"{MAX_SMEM_BYTES} a block has; use sketch_step")
    t = torch.empty((nb, max_power), dtype=torch.float32, device=R.device)
    if t.numel() == 0:
        return t
    lib = _build.library("sketch_chain", _CHAIN_SYMBOL, _CHAIN_ARGTYPES)
    with torch.cuda.device(R.device):
        _build.launch("sketch_chain", lib, _CHAIN_SYMBOL, R.data_ptr(),
                      St.data_ptr(), t.data_ptr(), nb, n, p, max_power,
                      smem, int(R.dtype == torch.bfloat16),
                      _build.stream_handle(R))
    return t


_STEP_SYMBOL = "prism_sketch_step"
_STEP_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p]


def sketch_step(R: torch.Tensor, V: torch.Tensor, St: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on contiguous CUDA R [Bt, n, n], V [Bt, n, p], St [n, p]:
    (V' = R @ V rounded to R's dtype, t' [Bt] fp32), one launch."""
    _build.check_cuda_operands("sketch_step", (R, V))
    nb, n, n2 = R.shape
    if n != n2:
        raise ValueError(f"sketch_step: R must be square, got "
                         f"{tuple(R.shape)}")
    _build.check_companion("sketch_step", R, St)
    p = _check_sketch("sketch_step", n, St)
    if tuple(V.shape) != (nb, n, p):
        raise ValueError(f"sketch_step: V {tuple(V.shape)} is not "
                         f"{(nb, n, p)}")
    Vn = torch.empty_like(V)
    t = torch.empty((nb,), dtype=torch.float32, device=R.device)
    if V.numel() == 0:
        return Vn, t.zero_()
    tiles = (n + STEP_ROWS - 1) // STEP_ROWS
    partial = torch.empty((nb, tiles), dtype=torch.float32, device=R.device)
    counter = torch.zeros((nb,), dtype=torch.int32, device=R.device)
    lib = _build.library("sketch_step", _STEP_SYMBOL, _STEP_ARGTYPES)
    with torch.cuda.device(R.device):
        _build.launch("sketch_step", lib, _STEP_SYMBOL, R.data_ptr(),
                      V.data_ptr(), St.data_ptr(), Vn.data_ptr(),
                      t.data_ptr(), partial.data_ptr(), counter.data_ptr(),
                      nb, n, p, int(R.dtype == torch.bfloat16),
                      _build.stream_handle(R))
    return Vn, t
