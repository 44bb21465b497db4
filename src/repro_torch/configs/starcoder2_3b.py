"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173; hf]

The port's own copy of ``repro/configs/starcoder2_3b.py``, field for field.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    head_dim=128, d_ff=12288, vocab_size=49152,
    qk_norm=False, qkv_bias=True, mlp_act="gelu",
    rope_theta=100_000.0,
)

SMOKE = CONFIG.replace(
    name="starcoder2-3b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
