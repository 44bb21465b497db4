"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attn, pattern (rec, rec, attn).
[arXiv:2402.19427; hf]

26 layers = 8 full periods + 2 recurrent tail layers; local window 2048
=> bounded decode state => long_500k runs.

The port's own copy of ``repro/configs/recurrentgemma_2b.py``, field for field.
"""
from repro_torch.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    head_dim=256, d_ff=7680, vocab_size=256000,
    qk_norm=False, qkv_bias=False, mlp_act="gelu",
    scale_embeddings=True, logits_softcap=30.0, tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560, conv_dim=4, attention_window=2048,
                      pattern=("recurrent", "recurrent", "attention")),
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke", num_layers=5, d_model=64, num_heads=4,
    num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
    rglru=RGLRUConfig(lru_width=64, conv_dim=4, attention_window=16,
                      pattern=("recurrent", "recurrent", "attention")))
