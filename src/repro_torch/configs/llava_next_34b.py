"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling (frontend stubbed: ``input_specs`` provides
precomputed patch embeddings).  [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]

The port's own copy of ``repro/configs/llava_next_34b.py``, field for field.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=20480, vocab_size=64000,
    qk_norm=False, qkv_bias=False, mlp_act="silu",
    rope_theta=5_000_000.0,
    # anyres tiling: base 576 patches + 4 tiles x 576 = 2880 patch embeds
    num_patches=2880, vision_dim=1152,
)

SMOKE = CONFIG.replace(
    name="llava-next-34b-smoke", num_layers=2, d_model=64, num_heads=8,
    num_kv_heads=2, head_dim=8, d_ff=128, vocab_size=256,
    num_patches=16, vision_dim=32)
