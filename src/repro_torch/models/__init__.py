"""Model zoo of the port: the decoder of the dense, moe, vlm and audio
families."""
from repro_torch.models.transformer import Model, param_specs

__all__ = ["Model", "param_specs"]
