"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01;
unverified]

The port's own copy of ``repro/configs/command_r_35b.py``, field for field.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22528, vocab_size=256000,
    qk_norm=False, qkv_bias=False, mlp_act="silu",
    rope_theta=8_000_000.0,
)

SMOKE = CONFIG.replace(
    name="command-r-35b-smoke", num_layers=2, d_model=64, num_heads=8,
    num_kv_heads=2, head_dim=8, d_ff=160, vocab_size=512)
