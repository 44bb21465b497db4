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
constant-alpha run as one launch, and ``residual_chain`` + ``apply_g`` a
fitted iteration as two, for the polar, sign and coupled sqrt families
(the coupled ones take and return the pair (X, Y)).  On the TPU the tier
was chosen by a model of VMEM (~16 MiB a core, double-buffered grid
blocks padded to 128 lanes).
On Hopper each of the three kernels keeps one slice's working set in the
shared memory of ONE block, so the model is the largest of the three
blocks' footprints (``fused_smem_bytes``, computed by the functions the
kernels lay their buffers out with) against the per-block maximum of
232,448 bytes.  It depends on the matrix shape, dtype and sketch dim
only, never on the batch size (the batch is the grid).  The config field
``vmem_budget`` keeps its name and now overrides that per-block budget in
bytes; there is no environment variable.

Sketched traces (``sketch_traces``): K5 runs the whole chain of a bucket
in one launch, one thread-block cluster a slice, when a cluster block's
two V buffers, ring of R and sketch rows fit its shared memory
(``sketch_traces.chain_smem_bytes`` against the same budget) and the card
can hold at least one of its clusters at once; else a loop of K4
launches, one per power, which needs no cluster (``chain_route``).  The
route is chosen before any launch, as the reference chose by footprint;
K5 itself still refuses a cluster that cannot be resident.  The
reference padded the sketch dim p to 128 TPU lanes; the CUDA kernels take
any p up to 16 as it is, so nothing is padded.

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
from repro_torch.kernels import sketch_traces as _sk

DEFAULT_SMEM_BUDGET = _fused.MAX_SMEM_BYTES


def smem_budget(override: int = 0) -> int:
    """Shared-memory budget of one fused-tier block in bytes: the config's
    ``vmem_budget`` when set, else the card's per-block maximum."""
    return int(override) if override else DEFAULT_SMEM_BUDGET


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def fused_smem_bytes(mshape, dtype, *, sketch_dim: int = 8,
                     coupled: bool = False) -> int:
    """Shared memory the fused tier needs for one [m, n] slice: the
    largest block of the kernels a fused bucket runs (K3, K6 with a
    ``sketch_dim``-row sketch, K7), with the coupled sqrt family's Y and
    fp32 residual when ``coupled``."""
    m, n = int(mshape[-2]), int(mshape[-1])
    item = _itemsize(dtype)
    return max(_fused.smem_bytes(m, n, item, coupled),
               _fused.residual_chain_smem_bytes(m, n, max(sketch_dim, 1),
                                                item, coupled),
               _fused.apply_g_smem_bytes(m, n, item, coupled))


def fused_fits(mshape, dtype, *, budget: int = 0, sketch_dim: int = 8,
               coupled: bool = False) -> bool:
    """Fused-tier choice for a bucket of [m, n] matrices (``coupled``: the
    sqrt family's (X, Y) pair)."""
    return fused_smem_bytes(mshape, dtype, sketch_dim=sketch_dim,
                            coupled=coupled) <= \
        min(smem_budget(budget), _fused.MAX_SMEM_BYTES)


def chain_fits(n: int, p: int, dtype, *, budget: int = 0) -> bool:
    """Whether one block of K5's cluster fits the budget for the chain of
    an [n, n] residual with a p-row sketch (``chain_route`` also asks the
    card whether it holds one of its clusters)."""
    return _sk.chain_smem_bytes(n, p, _itemsize(dtype)) <= \
        min(smem_budget(budget), _sk.MAX_SMEM_BYTES)


def chain_route(n: int, p: int, dtype, *, budget: int = 0,
                resident_clusters: int) -> str:
    """The kernel that runs the sketched chain of an [n, n] residual with a
    p-row sketch, chosen before any launch: ``"sketch_chain"`` (K5, one
    launch) when one block of its cluster fits the budget (``chain_fits``)
    and the card holds at least one of its clusters at once
    (``resident_clusters``, ``sketch_traces.resident_clusters``), else
    ``"sketch_step"`` (K4, one launch a power)."""
    if chain_fits(n, p, dtype, budget=budget) and resident_clusters > 0:
        return "sketch_chain"
    return "sketch_step"


def polar_flops(mshape, *, iters: int, degree: int = 2) -> int:
    """Modeled GEMM FLOPs of the cubic polar path on one [m, n] view.

    Per NS iteration (polar transposes to m >= n, Gram side n): the Gram
    residual X^T X (2 m n^2), the (degree-1) [n, n] Horner GEMMs
    (2 n^3 each) and the [m, n] x [n, n] apply (2 m n^2).  The sketch
    chain's O(n^2 p) is omitted — negligible by construction (§6).
    """
    m, n = int(mshape[-2]), int(mshape[-1])
    m, n = max(m, n), min(m, n)
    return iters * (4 * m * n * n + 2 * (degree - 1) * n ** 3)


def lowrank_polar_flops(mshape, l: int, *, iters: int, degree: int = 2,
                        power_iters: int = 1) -> int:
    """Modeled GEMM FLOPs of the §14 lowrank tier on one [m, n] view:
    sketch product + power iterations + project + lift (O(mnl) each),
    plus the two l-Gram-side NS chains (rangefinder polar on [m, l], the
    fitted subspace polar on [l, n])."""
    m, n = int(mshape[-2]), int(mshape[-1])
    m, n = max(m, n), min(m, n)
    l = int(l)
    products = (2 + 2 * power_iters) * 2 * m * n * l  # sketch+power+B+lift
    q_chain = polar_flops((m, l), iters=iters, degree=degree)
    sub_chain = polar_flops((n, l), iters=iters, degree=degree)
    return products + q_chain + sub_chain


def polar_hbm_bytes(mshape, dtype, *, iters: int) -> int:
    """Modeled device-memory traffic of the cubic path: each iteration
    streams X twice (Gram + apply) and R twice (write + Horner read)."""
    m, n = int(mshape[-2]), int(mshape[-1])
    m, n = max(m, n), min(m, n)
    return iters * (2 * m * n + 2 * n * n) * _itemsize(dtype)


def lowrank_polar_hbm_bytes(mshape, l: int, dtype, *, iters: int,
                            power_iters: int = 1) -> int:
    """Modeled device-memory traffic of the §14 tier: M streams once per
    O(mnl) product; the chains stream their [m, l] / [l, n] iterates."""
    m, n = int(mshape[-2]), int(mshape[-1])
    m, n = max(m, n), min(m, n)
    item = _itemsize(dtype)
    products = (2 + 2 * power_iters) * (m * n + m * l + n * l) * item
    chains = iters * (2 * (m * l + l * l) + 2 * (n * l + l * l)) * item
    return products + chains


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
    memory sees one read and one write of X (and Y) for the whole run
    (DESIGN.md §10).  ``alphas``: static per-iteration floats.  Returns X'
    or, for the coupled sqrt family, (X', Y')."""
    alphas = tuple(float(a) for a in alphas)
    coeffs = _gd_coeffs(degree)
    if not _on_cuda(X, Y):
        return _ref.warm_tail(X, alphas, coeffs=coeffs, family=family, Y=Y)
    lead = tuple(X.shape[:-2])
    Xb, Yb = _collapse(lead, X, Y)
    out = _fused.warm_tail(Xb, alphas, coeffs=coeffs, family=family, Y=Yb)
    if Y is None:
        return out.reshape(lead + tuple(out.shape[1:]))
    return tuple(o.reshape(lead + tuple(o.shape[1:])) for o in out)


def sketch_traces(R, S, max_power: int, *, budget: int = 0):
    """t_i = tr(S R^i S^T), i = 0..max_power, fp32 [..., max_power + 1]:
    one K5 launch for the whole bucket, or ``max_power`` K4 launches, as
    ``chain_route`` picks.  t_0 is sketch-only and computed here."""
    if not _on_cuda(R, S):
        return _ref.sketch_traces(R, S, max_power)
    St = S.transpose(-1, -2).to(R.dtype).contiguous()
    St32 = St.float()
    t0 = torch.sum(St32 * St32)
    lead = tuple(R.shape[:-2])
    (Rb,) = _collapse(lead, R)
    n, p = St.shape
    clusters = (_sk.resident_clusters(Rb, St)
                if chain_fits(n, p, R.dtype, budget=budget) else 0)
    if chain_route(n, p, R.dtype, budget=budget,
                   resident_clusters=clusters) == "sketch_chain":
        ts = _sk.sketch_chain(Rb, St, max_power)
    else:
        V = St.expand((Rb.shape[0],) + tuple(St.shape)).contiguous()
        steps = []
        for _ in range(max_power):
            V, t_i = _sk.sketch_step(Rb, V, St)
            steps.append(t_i)
        ts = torch.stack(steps, dim=-1)
    t = torch.cat([t0.expand(ts.shape[:-1] + (1,)), ts], dim=-1)
    return t.reshape(lead + (max_power + 1,))


def residual_chain(X, S, max_power: int, *, family: str = "polar", Y=None):
    """(R, t): the family residual AND the whole sketched power-trace
    chain in ONE launch (K6) — R reaches device memory once, as the output
    the Horner launch reads.  X: [..., m, n]; S: [p, n]; Y: the coupled
    sqrt family's second iterate.  Returns R [..., n, n] in X's dtype and
    fp32 traces t [..., max_power + 1] for powers 0..max_power (t_0 is
    sketch-only, computed here)."""
    S32 = S.float()
    t0 = torch.sum(S32 * S32)
    lead = tuple(X.shape[:-2])
    if not _on_cuda(X, S, Y):
        R, ts = _ref.residual_chain(X, S, max_power, family=family, Y=Y)
    else:
        Xb, Yb = _collapse(lead, X, Y)
        St = S.transpose(-1, -2).to(X.dtype).contiguous()
        Rb, ts = _fused.residual_chain(Xb, St, max_power, family=family,
                                       Y=Yb)
        n = Rb.shape[-1]
        R = Rb.reshape(lead + (n, n))
        ts = ts.reshape(lead + (max_power,))
    t = torch.cat([t0.expand(ts.shape[:-1] + (1,)), ts], dim=-1)
    return R, t


def apply_g(X, R, alpha, *, degree: int, Y=None):
    """X g_d(R; alpha) (and, coupled, g_d(R; alpha) Y): the d Horner GEMMs
    of each side in ONE launch (K7), the fp32 alpha applied on the fp32
    accumulator and never rounded first (DESIGN.md §9/§10).  alpha: a
    float or an fp32 tensor over X's leading dims, on X's device; it is
    read per slice by the kernel and never copied to or from the host.
    Returns X' or, with ``Y``, (X', Y')."""
    coeffs = _gd_coeffs(degree)
    if not _on_cuda(X, R, Y):
        return _ref.apply_g(X, R, alpha, coeffs=coeffs, Y=Y)
    lead = tuple(X.shape[:-2])
    Xb, Rb, Yb = _collapse(lead, X, R, Y)
    nb = Xb.shape[0]
    if torch.is_tensor(alpha):
        a = alpha.to(torch.float32).expand(lead).reshape(nb).contiguous()
    else:
        a = torch.full((nb,), float(alpha), dtype=torch.float32,
                       device=X.device)
    out = _fused.apply_g(Xb, Rb, a, coeffs=coeffs, Y=Yb)
    if Y is None:
        return out.reshape(lead + tuple(out.shape[1:]))
    return tuple(o.reshape(lead + tuple(o.shape[1:])) for o in out)


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
