"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens (4 codebooks; EnCodec
frontend stubbed: inputs are the token codes).  [arXiv:2306.05284; hf]

The port's own copy of ``repro/configs/musicgen_medium.py``, field for field.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    qk_norm=False, qkv_bias=False, mlp_act="gelu",
    num_codebooks=4,
)

SMOKE = CONFIG.replace(
    name="musicgen-medium-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=64, num_codebooks=4)
