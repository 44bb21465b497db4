"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA.  [arXiv:2401.04088; hf]

8 experts < 16-way model axis => per-expert tensor sharding (TP).
Sliding window (4096) makes decode state bounded => long_500k runs.

The port's own copy of ``repro/configs/mixtral_8x7b.py``, field for field.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    qk_norm=False, qkv_bias=False, mlp_act="silu",
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2, sharding="tensor"),
)

SMOKE = CONFIG.replace(
    name="mixtral-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=256, sliding_window=32,
    moe=MoEConfig(num_experts=4, num_experts_per_tok=2, sharding="tensor"))
