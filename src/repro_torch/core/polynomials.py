"""Polynomial algebra of the PRISM meta-algorithm (counterpart of
``repro/core/polynomials.py``).

Only the Taylor table the warm-only Newton-Schulz path needs is ported so
far; the residual polynomials, trace-weight maps and constrained
minimizers of the alpha fit come with slice 2 (ROADMAP.md Queue 1
item 2).
"""
from __future__ import annotations

import numpy as np


def taylor_inv_sqrt(d: int) -> np.ndarray:
    """Coefficients (ascending) of the degree-d Taylor poly of (1-x)^{-1/2}.

    c_j = (2j-1)!! / (2j)!! = prod_{i<=j} (2i-1)/(2i);  c_0 = 1.
    """
    c = np.ones(d + 1, dtype=np.float64)
    for j in range(1, d + 1):
        c[j] = c[j - 1] * (2 * j - 1) / (2 * j)
    return c
