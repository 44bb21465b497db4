"""Model zoo of the port: the decoder of every family (dense, moe, vlm,
audio, ssm, hybrid)."""
from repro_torch.models.transformer import Model, param_specs

__all__ = ["Model", "param_specs"]
