"""Architecture registry: ``--arch <id>`` -> ModelConfig (counterpart of
``repro/configs/registry.py``).

Each architecture lives in its own module exposing CONFIG (the exact
published dims) and SMOKE (a reduced same-family config for CPU tests),
copied field for field from the reference's.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

_ARCHS = {
    "qwen3-14b": "qwen3_14b",
    "command-r-35b": "command_r_35b",
    "qwen2.5-32b": "qwen2_5_32b",
    "starcoder2-3b": "starcoder2_3b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llava-next-34b": "llava_next_34b",
    "musicgen-medium": "musicgen_medium",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mixtral-8x7b": "mixtral_8x7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    # the paper's own Muon experiment model (Sec. 6.2)
    "gpt2-paper": "gpt2_paper",
}


def arch_ids():
    return [a for a in _ARCHS if a != "gpt2-paper"]


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
