"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Expert dim (32) divides the model mesh axis (16) => EP sharding.

The port's own copy of ``repro/configs/granite_moe_1b_a400m.py``, field for
field.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=64, d_ff=512, vocab_size=49155,
    qk_norm=False, qkv_bias=False, mlp_act="silu",
    moe=MoEConfig(num_experts=32, num_experts_per_tok=8, sharding="expert"),
)

SMOKE = CONFIG.replace(
    name="granite-moe-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2, sharding="expert"))
