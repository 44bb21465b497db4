"""Where the port's entry points run."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Naming no device on a machine without a CUDA device raises instead of
    quietly running the plain versions on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on a CUDA device unless a "
                "device is named, and no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
