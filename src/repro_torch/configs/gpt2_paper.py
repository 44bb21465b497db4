"""The paper's own Muon experiment model (Sec. 6.2 / App. C):
"GPT-2 Large ... with 10 layers, 16 attention heads, and an embedding
dimension of 1024", trained on FineWeb-like token streams.

The port's own copy of ``repro/configs/gpt2_paper.py``, field for field.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-paper", family="dense",
    num_layers=10, d_model=1024, num_heads=16, num_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=50257,
    qk_norm=False, qkv_bias=True, mlp_act="gelu",
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    name="gpt2-paper-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
