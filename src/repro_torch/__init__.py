"""PyTorch port of the PRISM training stack, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it or JAX.  The layout follows the reference so each
counterpart is easy to find: ``config``, ``configs/``, ``kernels/``,
``core/``, ``optim/``, ``models/``, ``data/``, ``train/``, ``launch/``.

Float32 matrix products and convolutions run in full float32: TF32 is
switched off here, on import, because the tolerances the port is held to
(kernels/ops.py, tests/test_torch_*.py) rule it out.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve_device``); on a CPU tensor every kernel
wrapper takes its plain PyTorch version, on a CUDA tensor it launches the
hand-written kernel or raises.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
