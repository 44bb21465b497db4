"""Hand-written Hopper kernels of the PRISM hot spots.

  matmul_add     D = alpha A @ B + beta C      (K1, fused Horner step)
  gram           R = alpha I + beta X^T X      (K2, upper tiles + mirror)
  sketch_traces  sketch_step: one chain power (K4); sketch_chain: the
                 whole sketched trace chain in one launch (K5)
  fused_iter     warm_tail: a constant-alpha run in one launch (K3);
                 residual_chain: residual + sketch chain (K6); apply_g:
                 the Horner application with a per-slice fitted alpha (K7)

``ops`` dispatches by device (CPU -> the plain versions in ``ref``, CUDA
-> the kernels), collapses batch dims and counts launches; ``_build``
compiles ``csrc/`` with nvcc at first use.
"""
from repro_torch.kernels import fused_iter, ops, ref, sketch_traces

__all__ = ["fused_iter", "ops", "ref", "sketch_traces"]
