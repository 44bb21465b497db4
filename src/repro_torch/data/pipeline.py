"""Deterministic synthetic data pipeline (counterpart of
``repro/data/pipeline.py``).

Tokens come from a fixed random low-rank bigram (Markov) source, so
optimizer runs show real learning — uniform random tokens would make
every optimizer look identical.  ``batch_for_step(step)`` is a pure
function of (seed, step).  Audio batches draw batch * K rows of tokens
and shape them [B, K, S]; vlm batches add bf16 patch embeddings from a
generator of their own (seed + 2), as the reference does.  Drawn with
``torch.Generator``s on the target device: the same distribution as the
reference, not the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 50257
    seq_len: int = 1024
    global_batch: int = 32
    seed: int = 1234
    markov_rank: int = 64  # low-rank bigram structure (learnability knob)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def bigram_factors(cfg: DataConfig, device):
    """Low-rank factors of the bigram transition logits (fixed by seed)."""
    g = _generator(device, cfg.seed)
    U = torch.randn((cfg.vocab_size, cfg.markov_rank), generator=g,
                    device=device) * 1.5
    V = torch.randn((cfg.markov_rank, cfg.vocab_size), generator=g,
                    device=device) * 1.5
    return U, V


def sample_tokens(cfg: DataConfig, step: int, batch: int, factors,
                  device, num_codebooks: int = 0) -> torch.Tensor:
    """[batch, seq] (or [batch, K, seq]) int64 tokens for this step."""
    U, V = factors
    g = _generator(device, (cfg.seed + 1) * 1_000_003 + int(step))
    rows = batch * max(num_codebooks, 1)
    x = torch.randint(0, cfg.vocab_size, (rows,), generator=g,
                      device=device)
    toks = [x]
    inv_t = 1.0 / np.sqrt(cfg.markov_rank)
    for _ in range(cfg.seq_len - 1):
        probs = torch.softmax((U[x] @ V) * inv_t, dim=-1)
        x = torch.multinomial(probs, 1, generator=g)[:, 0]
        toks.append(x)
    toks = torch.stack(toks, dim=1)
    if num_codebooks:
        return toks.reshape(batch, num_codebooks, cfg.seq_len)
    return toks


def make_batch_fn(model_cfg: ModelConfig, data_cfg: DataConfig,
                  device=None):
    """Returns batch_for_step(step) -> the model's input dict on
    ``device`` (CUDA unless named): {"tokens"} ([B, S], or [B, K, S] for
    audio), plus "patches" [B, P, vision_dim] bf16 for vlm."""
    dev = resolve_device(device)
    factors = bigram_factors(data_cfg, dev)
    books = model_cfg.num_codebooks if model_cfg.family == "audio" else 0
    B = data_cfg.global_batch

    def batch_for_step(step: int):
        out = {"tokens": sample_tokens(data_cfg, step, B, factors, dev,
                                       books)}
        if model_cfg.family == "vlm":
            g = _generator(dev, (data_cfg.seed + 2) * 1_000_003 + int(step))
            out["patches"] = torch.randn(
                (B, model_cfg.num_patches, model_cfg.vision_dim),
                generator=g, device=dev).to(torch.bfloat16)
        return out

    return batch_for_step
