"""Carry parameters and optimizer state across between the reference
package and the port.

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

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.models.transformer import param_specs

#: the per-parameter state keys of the reference's Shampoo that the port
#: carries (optim/shampoo.py): momentum, the EMA Kronecker factors, their
#: cached inverse roots, the diagonal fallback and Adam's second moment
SHAMPOO_STATE_KEYS = ("mom", "L", "R", "Linv", "Rinv", "diagL", "diagR",
                      "nu")


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


def shampoo_state_from_jax(opt, named_params, state: Dict[str, Any]) -> None:
    """Install the reference's Shampoo state into the port's ``Shampoo``
    ``opt`` (built over ``named_params``): ``state`` is what
    ``make_shampoo(...).init``/``update`` return, {"leaves": a tree of
    per-parameter dicts shaped like the parameters, "count": int}, arrays
    as numpy (bf16 allowed).  The cached inverse roots take the port's
    ``cache_dtype``, everything else fp32; a key the port does not carry
    (the async and telemetry twins) raises."""
    cache = torch_dtype(opt.cfg.cache_dtype)
    leaves = state["leaves"]
    for name, p in named_params:
        node = leaves
        for part in name.split("."):
            node = node[part]
        unknown = sorted(set(node) - set(SHAMPOO_STATE_KEYS))
        if unknown:
            raise KeyError(f"{name}: state keys {unknown} are not carried "
                           f"by the port's Shampoo")
        opt.state[p] = {
            k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy()).to(
                device=p.device,
                dtype=cache if k in ("Linv", "Rinv") else torch.float32)
            for k, v in node.items()}
    opt.count = int(np.asarray(state["count"]))
