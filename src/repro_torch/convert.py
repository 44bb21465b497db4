"""Carry parameters across between the reference package and the port.

The reference keeps parameters as a nested dict of arrays (``Model.init``);
the port as a flat name -> tensor dict with dotted names
(``layers.attn.wq``), same shapes, same layout.  Arrays cross as numpy
(e.g. ``np.asarray`` of each reference leaf), so this module imports
neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import param_specs


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """The port's fp32 master parameters from the reference's parameter
    tree of numpy arrays (any float dtype, bf16 included: every bf16 value
    is exact in fp32).  Names and shapes must match ``cfg`` exactly."""
    flat = _flatten(tree)
    specs = param_specs(cfg)
    if set(flat) != set(specs):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(specs) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(specs))}")
    out = {}
    for name, (shape, _, _) in specs.items():
        a = np.asarray(flat[name], dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(shape)}")
        out[name] = torch.from_numpy(a.copy())
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``params_from_jax``: a nested dict of fp32 numpy arrays
    in the reference's tree layout."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree
