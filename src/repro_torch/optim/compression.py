"""Gradient compression for data parallelism (counterpart of
``repro/optim/compression.py``).

int8 blockwise quantization with one fp32 scale a block of ``BLOCK``
values (1/256 of the payload):

  int8_roundtrip(tensors)   quantize and dequantize each tensor: the
                            numerics of a compressed reduction applied to
                            reduced gradients (``train/state.py``), as the
                            reference applies them inside its jitted step.
  int8_psum(x, group)       quantize -> one fp32 MAX all-reduce of the
                            [-, 1] scale column -> one int32 SUM all-reduce
                            of the payload rescaled to the shared scale ->
                            dequantize: the reference's operation order.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch import collectives

BLOCK = 256


def _quantize(x: torch.Tensor):
    xf = x.float().reshape(-1)
    pad = (-xf.shape[0]) % BLOCK
    xp = torch.nn.functional.pad(xf, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(xp), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape), pad


def _dequantize(q, scale, shape, pad) -> torch.Tensor:
    xf = (q.float() * scale).reshape(-1)
    if pad:
        xf = xf[:-pad]
    return xf.reshape(shape)


def int8_roundtrip_leaf(x: torch.Tensor) -> torch.Tensor:
    q, s, shape, pad = _quantize(x)
    return _dequantize(q, s, shape, pad).to(x.dtype)


def int8_roundtrip(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [int8_roundtrip_leaf(x) for x in tensors]


def int8_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` through the int8 wire format: the
    scales differ a rank, so each rank re-expresses its payload against
    the block's largest scale (one fp32 MAX over the scale column), and
    the int32 SUM of the rescaled payloads is the only full-size
    collective."""
    q, s, shape, pad = _quantize(x)
    smax = collectives.all_reduce(s.clone(), "max", group)
    ratio = s / smax
    qr = torch.round(q.float() * ratio).to(torch.int32)
    qsum = collectives.all_reduce(qr, "sum", group)
    out = (qsum.float() * smax).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(x.dtype)
