"""Matrix-function core: polar via (PRISM-)Newton-Schulz."""
from repro_torch.core import matfn, newton_schulz, polynomials

__all__ = ["matfn", "newton_schulz", "polynomials"]
