"""Architecture configs ported so far (the dense gpt2-paper model)."""
from repro_torch.configs import gpt2_paper

__all__ = ["gpt2_paper"]
