"""Architecture configs: the registry (``--arch <id>``) over one module
per published model."""
from repro_torch.configs import gpt2_paper
from repro_torch.configs.registry import (arch_ids, get_config,
                                          get_smoke_config)

__all__ = ["arch_ids", "get_config", "get_smoke_config", "gpt2_paper"]
