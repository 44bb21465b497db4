"""K4 ``sketch_step`` and K5 ``sketch_chain``: the sketched power traces
of PRISM's alpha fit as hand-written CUDA kernels.

Counterpart of ``repro/kernels/sketch_traces.py``.  A fit needs
t_i = tr(S R^i S^T), i = 1..max_power, through the chain V_i = R V_{i-1}
with V_0 = St = S^T ([n, p], shared across the batch).  Each trace is
reduced in fp32 from the fp32 accumulator of R @ V before V' rounds to
the operand dtype (DESIGN.md §9).

  * ``sketch_chain`` (K5, ``csrc/sketch_chain.cu``): the whole chain of a
    [B, n, n] bucket in ONE launch, one thread-block cluster of
    ``CHAIN_CLUSTER`` blocks a slice (rank r owns rows ``chain_row_split``
    of R), with the two V ping-pong buffers in every block's shared
    memory, filled through distributed shared memory; R streams from
    device memory (or L2) once per power.  Its footprint
    ``chain_smem_bytes`` grows with n, so ``ops.sketch_traces`` launches it
    only when it fits one block.
  * ``sketch_step`` (K4, ``csrc/sketch_step.cu``): one power, a grid over
    (row tile, slice) with a footprint that does not grow with n (R
    streamed through each thread's cp.async ring, V staged a k-tile at a
    time); the fallback loop of ``ops.sketch_traces``, which needs no
    cluster.  A warp carries K5's row group, so every V'[row, c] is summed
    in K5's order.  The trace is a sum across blocks, reduced in a fixed
    order (per-tile partials, then the last block of each slice sums them
    in order and sets the slice's arrival counter back to zero), so it is
    the same from run to run, and the counters (``step_counter``) are
    zeroed once, never per call.

``sketch`` p may be at most ``MAX_SKETCH``; there is no padding of p.
``plain_chain``/``plain_step`` are the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, ref

MAX_SMEM_BYTES = 232_448
MAX_SKETCH = 16
# K4's layout, mirrored from csrc/sketch_step.cu
STEP_THREADS = 256
STEP_WARPS = STEP_THREADS // 32
STEP_GROUP_SUMS = 64   # sums a lane carries: rows a warp x (8 or 16)
# K5's layout, mirrored from csrc/sketch_chain.cu
CHAIN_CLUSTER = 16     # blocks a slice
CHAIN_THREADS = 256
CHAIN_WARPS = CHAIN_THREADS // 32
CHAIN_STAGES = 2       # ring slots of R a thread
CHAIN_GROUP_SUMS = 64  # sums a lane carries: rows a warp x (8 or 16)


def plain_chain(R: torch.Tensor, St: torch.Tensor, max_power: int
                ) -> torch.Tensor:
    """Traces of powers 1..max_power, [B, max_power] fp32."""
    return ref._chain(R, St, max_power)[0]


def plain_step(R: torch.Tensor, V: torch.Tensor, St: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ref.sketch_step(R, V, St)


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def chain_row_split(n: int, cluster: int = CHAIN_CLUSTER
                    ) -> List[Tuple[int, int]]:
    """(first row, rows) of R that each rank of a K5 cluster owns:
    ceil(n / cluster) rows a rank, in rank order; ranks past n own none."""
    q = -(-n // cluster)
    return [(min(n, r * q), max(0, min(q, n - r * q)))
            for r in range(cluster)]


def chain_rows_a_warp(p: int) -> int:
    """Rows of R a K5 warp carries at a time: ``CHAIN_GROUP_SUMS`` sums
    over a register tile 8 or 16 wide (p <= 8 or p <= 16)."""
    return CHAIN_GROUP_SUMS // (8 if p <= 8 else 16)


def chain_smem_bytes(n: int, p: int, itemsize: int) -> int:
    """Shared memory of one K5 block — the layout ``csrc/sketch_chain.cu``
    uses: the two V buffers ([8 or 16, n] each, the register tile's width
    at least p, operand dtype, 16-byte aligned), each thread's ring of
    ``CHAIN_STAGES`` steps of R (16 bytes a row a step), St at the rank's
    rows, and the fp32 trace partials (one a warp, and the ranks' of two
    powers)."""
    ring = CHAIN_STAGES * chain_rows_a_warp(p) * 16 * CHAIN_THREADS
    rank_rows = chain_row_split(n)[0][1]
    width = 8 if p <= 8 else 16
    return (2 * _align16(width * n * itemsize) + ring
            + _align16(rank_rows * p * itemsize)
            + 4 * (CHAIN_WARPS + 2 * CHAIN_CLUSTER))


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


def _chain_operands(R: torch.Tensor, St: torch.Tensor) -> Tuple[int, int]:
    """(n, p) of a K5 launch on R [Bt, n, n] and St [n, p]; raises on
    operands the kernel does not take."""
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
    return n, p


def sketch_chain(R: torch.Tensor, St: torch.Tensor, max_power: int
                 ) -> torch.Tensor:
    """Launch K5 on a contiguous CUDA R [Bt, n, n] and St [n, p] (one
    dtype, fp32 or bf16): fp32 traces [Bt, max_power] of powers
    1..max_power, one cluster launch.  Raises when the card cannot hold
    one cluster at this footprint."""
    n, p = _chain_operands(R, St)
    nb = R.shape[0]
    t = torch.empty((nb, max_power), dtype=torch.float32, device=R.device)
    if t.numel() == 0:
        return t
    lib = _build.library("sketch_chain", _CHAIN_SYMBOL, _CHAIN_ARGTYPES)
    with torch.cuda.device(R.device):
        _build.launch("sketch_chain", lib, _CHAIN_SYMBOL, R.data_ptr(),
                      St.data_ptr(), t.data_ptr(), nb, n, p, max_power,
                      chain_smem_bytes(n, p, R.element_size()),
                      int(R.dtype == torch.bfloat16),
                      _build.stream_handle(R))
    return t


_INFO_SYMBOL = "prism_sketch_chain_info"
_INFO_KEYS = ("cluster", "active_clusters", "registers", "local_bytes",
              "threads", "stages", "rows_a_warp")


def chain_launch_info(R: torch.Tensor, St: torch.Tensor) -> Dict[str, int]:
    """What a K5 launch on these operands would run with: the cluster
    size, how many clusters the card holds at once at this footprint, the
    instantiation's registers and local (spilled) bytes a thread, threads
    a block, ring stages and rows a warp, and the footprint
    (``smem_bytes``).  Launches nothing."""
    n, p = _chain_operands(R, St)
    smem = chain_smem_bytes(n, p, R.element_size())
    lib = _build.library("sketch_chain", _CHAIN_SYMBOL, _CHAIN_ARGTYPES)
    fn = getattr(lib, _INFO_SYMBOL)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(_INFO_KEYS))()
    with torch.cuda.device(R.device):
        code = fn(R.data_ptr(), n, p, smem, int(R.dtype == torch.bfloat16),
                  out)
    if code != 0:
        raise RuntimeError(f"sketch_chain: launch query failed: "
                           f"{lib.prism_error_string(code).decode()} "
                           f"({code})")
    return dict(zip(_INFO_KEYS, out), smem_bytes=smem)

_CLUSTERS: Dict[Tuple, int] = {}


def resident_clusters(R: torch.Tensor, St: torch.Tensor) -> int:
    """How many K5 clusters the card holds at once for a launch on these
    operands (``chain_launch_info``'s ``active_clusters``): queried once
    per device, n, p, dtype and instantiation (16-byte loads or not), then
    cached.  Launches nothing."""
    n, p = R.shape[-1], St.shape[1]
    vec = n % (16 // R.element_size()) == 0 and R.data_ptr() % 16 == 0
    key = (R.device, n, p, R.dtype, vec)
    if key not in _CLUSTERS:
        _CLUSTERS[key] = chain_launch_info(R, St)["active_clusters"]
    return _CLUSTERS[key]


def step_rows_a_warp(p: int) -> int:
    """Rows of R a K4 warp carries: K5's row group (``chain_rows_a_warp``)."""
    return STEP_GROUP_SUMS // (8 if p <= 8 else 16)


def step_tiles(n: int, p: int) -> int:
    """Row-tile blocks of one K4 slice: ``STEP_WARPS`` warps a block, each
    with ``step_rows_a_warp(p)`` consecutive rows (warp w of block i owns
    rows (i STEP_WARPS + w) rows_a_warp onwards); a block writes one trace
    partial, [slice, tile]."""
    block_rows = STEP_WARPS * step_rows_a_warp(p)
    return -(-n // block_rows)


_COUNTERS: Dict[Tuple, torch.Tensor] = {}


def step_counter(device, stream: int, batch: int) -> torch.Tensor:
    """K4's arrival counters ([batch] int32) for launches on ``stream`` of
    ``device``: every launch leaves them zero (the last block of a slice
    resets its counter), so they are zeroed once, when first allocated or
    grown, and a call makes no fill launch.  One set a (device, stream):
    launches on one stream run in order, so they never share a counter
    while it counts."""
    key = (torch.device(device), stream)
    counter = _COUNTERS.get(key)
    if counter is None or counter.numel() < batch:
        counter = torch.zeros((batch,), dtype=torch.int32, device=device)
        _COUNTERS[key] = counter
    return counter


_STEP_SYMBOL = "prism_sketch_step"
_STEP_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
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
    tiles = step_tiles(n, p)
    partial = torch.empty((nb, tiles), dtype=torch.float32, device=R.device)
    stream = _build.stream_handle(R)
    counter = step_counter(R.device, stream, nb)
    lib = _build.library("sketch_step", _STEP_SYMBOL, _STEP_ARGTYPES)
    with torch.cuda.device(R.device):
        _build.launch("sketch_step", lib, _STEP_SYMBOL, R.data_ptr(),
                      V.data_ptr(), St.data_ptr(), Vn.data_ptr(),
                      t.data_ptr(), partial.data_ptr(), counter.data_ptr(),
                      nb, n, p, tiles, int(R.dtype == torch.bfloat16),
                      stream)
    return Vn, t
