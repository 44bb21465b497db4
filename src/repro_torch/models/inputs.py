"""Synthetic model inputs per architecture (counterpart of
``repro/models/inputs.py``).

``make_train_batch`` builds a batch of the shapes and dtypes the model's
family takes: tokens [B, S] int32 ([B, K, S] for audio's K codebooks),
and for vlm the patch embeddings [B, P, vision_dim] in bf16, drawn in
fp32 and then cast, as the reference does.  Drawn from a
``torch.Generator`` on the target device: the reference's distributions,
not its bits.  The reference's ``*_specs`` (shape stand-ins for its dry
run) go with ROADMAP.md Queue 1 item 12.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig


def make_train_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                     seq: int, device=None) -> Dict[str, torch.Tensor]:
    device = gen.device if device is None else device
    out = {}
    shape = (batch, cfg.num_codebooks, seq) if cfg.family == "audio" \
        else (batch, seq)
    out["tokens"] = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                  dtype=torch.int32, device=device)
    if cfg.family == "vlm":
        out["patches"] = torch.randn(
            (batch, cfg.num_patches, cfg.vision_dim), generator=gen,
            dtype=torch.float32, device=device).to(torch.bfloat16)
    return out


def make_decode_inputs(gen: torch.Generator, cfg: ModelConfig, batch: int,
                       pos: int, device=None) -> Dict[str, torch.Tensor]:
    device = gen.device if device is None else device
    shape = (batch, cfg.num_codebooks, 1) if cfg.family == "audio" \
        else (batch, 1)
    tok = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                        dtype=torch.int32, device=device)
    return {"tokens": tok,
            "pos": torch.full((batch, 1), pos, dtype=torch.int32,
                              device=device)}
