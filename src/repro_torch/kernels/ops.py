"""Public wrappers around the CUDA kernels: device dispatch, batching, the
fused-tier shared-memory model and launch counting.

Dispatch: by the device of the tensors, nothing else.  CPU tensors take
the plain PyTorch versions in ``ref.py``; CUDA tensors launch the
hand-written kernel, or raise when it cannot take them.  There is no
interpret mode, no environment switch and no fallback: a CUDA tensor never
runs the plain version quietly.  (The reference package chose by JAX
backend and ``REPRO_KERNEL_MODE``.)

All wrappers accept leading batch dimensions, collapsed into the single
batch dimension of the kernels' grids (DESIGN.md §7): a whole [B, m, n]
parameter bucket is one launch, never a loop of B 2-D launches.

Precision (DESIGN.md §9): every kernel takes operands in the caller's
compute dtype (fp32 or bf16), accumulates in fp32 and rounds its output
once; ``ref.py`` keeps the same order, so the device never changes the
contract.  fp32 operands never use TF32.

Fused-iteration tier (DESIGN.md §10): ``warm_tail`` runs a whole
constant-alpha run as one launch.  On the TPU the tier was chosen by a
model of VMEM (~16 MiB a core, double-buffered grid blocks padded to
128 lanes).  On Hopper the K3 design keeps one slice's X, R, rounded
Horner operand and fp32 accumulator in the shared memory of ONE block, so
the model is that block's footprint (``fused_smem_bytes``, the same
formula the kernel lays its buffers out with) against the per-block
maximum of 232,448 bytes.  It depends on the matrix shape and dtype only,
never on the batch size (the batch is the grid).  The config field
``vmem_budget`` keeps its name and now overrides that per-block budget in
bytes; there is no environment variable.

Launch counting: each kernel wrapper adds one to ``_build.LAUNCHES`` per
launch.  PyTorch runs eagerly, so the counts are real launches, read with
``launch_counts``/``count_launches`` and zeroed with ``reset_launches``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.config import torch_dtype
from repro_torch.kernels import _build
from repro_torch.kernels import fused_iter as _fused
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import matmul_add as _mma
from repro_torch.kernels import ref as _ref

DEFAULT_SMEM_BUDGET = _fused.MAX_SMEM_BYTES


def smem_budget(override: int = 0) -> int:
    """Shared-memory budget of one fused-tier block in bytes: the config's
    ``vmem_budget`` when set, else the card's per-block maximum."""
    return int(override) if override else DEFAULT_SMEM_BUDGET


def fused_smem_bytes(mshape, dtype) -> int:
    """Shared memory one K3 block needs for one [m, n] slice."""
    m, n = int(mshape[-2]), int(mshape[-1])
    item = torch.empty((), dtype=torch_dtype(dtype)).element_size()
    return _fused.smem_bytes(m, n, item)


def fused_fits(mshape, dtype, *, budget: int = 0) -> bool:
    """Fused-tier choice for a bucket of [m, n] matrices."""
    return fused_smem_bytes(mshape, dtype) <= min(smem_budget(budget),
                                                   _fused.MAX_SMEM_BYTES)


def _gd_coeffs(degree: int):
    """Ascending Taylor coefficients f_0..f_{d-1} of g_d (floats)."""
    from repro_torch.core import polynomials as poly

    return tuple(float(c) for c in poly.taylor_inv_sqrt(degree - 1))


def _on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA operands, False for CPU ones; raises on a mix or any
    other device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel operands must all lie on the CPU or all on "
                     f"CUDA devices, got {sorted(kinds)}")


def _collapse(lead, *tensors):
    """Reshape shared leading batch dims of each tensor into one contiguous
    [B, ., .]; an unbatched operand broadcasts against the batch."""
    size = 1
    for d in lead:
        size *= d
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
        elif t.dim() > 2:
            out.append(t.reshape((size,) + tuple(t.shape[-2:])).contiguous())
        else:
            out.append(t.expand((size,) + tuple(t.shape)).contiguous())
    return out


def matmul_add(A, B, C=None, *, alpha: float = 1.0, beta: float = 0.0):
    """D = alpha * A @ B (+ beta * C), batched over leading dims."""
    if not _on_cuda(A, B, C):
        return _ref.matmul_add(A, B, C, alpha=alpha, beta=beta)
    lead = tuple(A.shape[:-2])
    Ab, Bb, Cb = _collapse(lead, A, B, C)
    out = _mma.matmul_add(Ab, Bb, Cb, alpha=alpha, beta=beta)
    return out.reshape(lead + tuple(out.shape[1:]))


def gram(X, *, alpha: float = 1.0, beta: float = -1.0):
    """R = alpha * I + beta * X^T X (symmetric), batched."""
    if not _on_cuda(X):
        return _ref.gram(X, alpha=alpha, beta=beta)
    lead = tuple(X.shape[:-2])
    (Xb,) = _collapse(lead, X)
    R = _gram.gram_upper(Xb, alpha=alpha, beta=beta)
    return R.reshape(lead + tuple(R.shape[-2:]))


def warm_tail(X, alphas: Sequence[float], *, degree: int,
              family: str = "polar", Y=None):
    """An entire run of constant-alpha iterations in ONE launch: device
    memory sees one read and one write of X for the whole run
    (DESIGN.md §10).  ``alphas``: static per-iteration floats."""
    if family != "polar" or Y is not None:
        raise NotImplementedError(
            f"warm_tail for the {family!r} family is ported with the "
            "sign/sqrt families and Shampoo (ROADMAP.md Queue 1 item 6)")
    alphas = tuple(float(a) for a in alphas)
    coeffs = _gd_coeffs(degree)
    if not _on_cuda(X):
        return _ref.warm_tail(X, alphas, coeffs=coeffs)
    lead = tuple(X.shape[:-2])
    (Xb,) = _collapse(lead, X)
    out = _fused.warm_tail(Xb, alphas, coeffs=coeffs)
    return out.reshape(lead + tuple(out.shape[1:]))


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last ``reset_launches``."""
    return dict(_build.LAUNCHES)


def reset_launches() -> None:
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def count_launches(fn, *args) -> Dict[str, int]:
    """Kernel launches per kernel that ``fn(*args)`` issues (the
    launch-count contract of DESIGN.md §7/§10).  Counts only real
    launches: CPU tensors take the plain versions and count nothing."""
    before = launch_counts()
    fn(*args)
    return {k: v - before[k] for k, v in launch_counts().items()}
