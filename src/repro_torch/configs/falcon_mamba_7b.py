"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — mamba1 arch.  [arXiv:2410.05355; unverified]

The port's own copy of ``repro/configs/falcon_mamba_7b.py``, field for field.
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65024,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
)

SMOKE = CONFIG.replace(
    name="falcon-mamba-7b-smoke", num_layers=2, d_model=64, vocab_size=256,
    ssm=SSMConfig(state_dim=4, conv_dim=4, expand=2))
