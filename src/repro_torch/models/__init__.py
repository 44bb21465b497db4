"""Model zoo of the port: the dense decoder so far."""
from repro_torch.models.transformer import Model, param_specs

__all__ = ["Model", "param_specs"]
