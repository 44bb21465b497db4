"""Sketch keys: the port's counterpart of ``jax.random`` keys.

The reference folds a PRNG key at every level of a training step: the
step counter (``train/state.py``), the bucket index
(``optim/bucketing.py``) and the iteration index
(``prism.alpha_schedule_key``), and draws each sketch with
``jax.random.normal``.  ``Key`` keeps that structure with a 64-bit seed
mixed in pure Python, and draws from a ``torch.Generator`` on the device
the sketch is used on, so a sketch costs no host-to-device copy and no
synchronization.

Every function of the port that takes a ``key`` uses only the methods
below (``fold_in``, ``normal`` and, for sampling, ``gumbel``).  That is
the injection seam: an object with the same methods built on
``jax.random`` (the tests' ``JaxKey``) makes the port draw exactly the
reference's sketches and sampling noise.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

_MASK = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijective 64-bit mix."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


class Key:
    """A deterministic sketch key: ``Key(seed).fold_in(i).normal(...)``."""

    __slots__ = ("seed",)

    def __init__(self, seed: int = 0):
        self.seed = int(seed) & _MASK

    def fold_in(self, data: int) -> "Key":
        """A new key for ``data`` (an int), independent of this one's
        other children."""
        return Key(_mix64(self.seed ^ _mix64(int(data) & _MASK)))

    def normal(self, shape: Sequence[int], dtype: torch.dtype,
               device: Union[str, torch.device]) -> torch.Tensor:
        """Standard normal draws of ``shape`` in ``dtype``, generated on
        ``device`` from this key alone."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                           device=device)

    def gumbel(self, shape: Sequence[int], dtype: torch.dtype,
               device: Union[str, torch.device]) -> torch.Tensor:
        """Standard Gumbel draws of ``shape`` in ``dtype`` on ``device``
        from this key alone (counterpart of ``jax.random.gumbel``):
        -log(-log(U)), U uniform and kept inside [tiny, 1 - eps / 2]."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        info = torch.finfo(dtype)
        u = torch.rand(tuple(shape), generator=gen, dtype=dtype,
                       device=device)
        u = torch.clamp(u, min=info.tiny, max=1.0 - info.eps / 2)
        return -torch.log(-torch.log(u))
