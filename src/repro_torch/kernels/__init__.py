"""Hand-written Hopper kernels of the PRISM GEMM hot spots.

  matmul_add  D = alpha A @ B + beta C      (K1, fused Horner step)
  gram        R = alpha I + beta X^T X      (K2, upper tiles + mirror)
  fused_iter  warm_tail: a whole constant-alpha run in one launch (K3)

``ops`` dispatches by device (CPU -> the plain versions in ``ref``, CUDA
-> the kernels), collapses batch dims and counts launches; ``_build``
compiles ``csrc/`` with nvcc at first use.
"""
from repro_torch.kernels import fused_iter, ops, ref

__all__ = ["fused_iter", "ops", "ref"]
