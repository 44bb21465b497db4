"""Carry parameters and optimizer state across between the reference
package and the port.

The reference keeps parameters as a nested dict of arrays (``Model.init``;
the hybrid's ``tail`` a list of layer dicts); the port as a flat name ->
tensor dict with dotted names (``layers.attn.wq``, ``tail.0.rglru.w_a``),
same shapes, same layout.  Arrays cross as numpy
(e.g. ``np.asarray`` of each reference leaf), so this module imports
neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.models.transformer import param_specs
from repro_torch.optim import base

#: the per-parameter state keys of the reference's Muon and Shampoo that
#: the port carries (optim/muon.py, optim/shampoo.py): momentum, Adam's
#: second moment, Muon's cached polar and tier, Shampoo's EMA Kronecker
#: factors, their cached inverse roots and the diagonal fallback, the
#: adaptive-tol telemetry, and the §12 refresh plane's pending twins and
#: drift proxy
MUON_STATE_KEYS = ("mom", "nu", "ortho", "tier", "iters", "status",
                   "ortho_p", "iters_p", "status_p", "dnorm", "rnorm")
SHAMPOO_STATE_KEYS = ("mom", "L", "R", "Linv", "Rinv", "diagL", "diagR",
                      "nu", "Linv_iters", "Rinv_iters", "Linv_status",
                      "Rinv_status", "Linv_p", "Rinv_p", "Linv_iters_p",
                      "Rinv_iters_p", "Linv_status_p", "Rinv_status_p",
                      "dnorm", "rnorm")


def _state_dtype(key: str, cache: torch.dtype) -> torch.dtype:
    stem = key[:-2] if key.endswith("_p") else key
    if stem in ("ortho", "Linv", "Rinv"):
        return cache
    if stem.endswith("iters") or stem == "tier":
        return torch.int32
    if stem.endswith("status"):
        return torch.int8
    return torch.float32


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """name -> leaf of a nested tree of dicts and lists; a list's items
    are named by their index (the hybrid's ``tail.0.ln1``)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _listify(node):
    """Turn every dict of the nested tree whose keys are 0..n-1 (as
    strings) into a list, as the reference keeps its ``tail``."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def _child(node, part: str):
    return node[int(part)] if isinstance(node, list) else node[part]


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """The port's fp32 master parameters from the reference's parameter
    tree of numpy arrays (any float dtype, bf16 included: every bf16 value
    is exact in fp32): every family ``param_specs`` covers, e.g.
    ``layers.moe.*``, audio's ``heads``, vlm's ``vision_proj`` and a tied
    tree with no ``head``.  Names and shapes must match ``cfg`` exactly;
    a name the port does not carry raises."""
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


def _tensor(a) -> torch.Tensor:
    """A torch copy of numpy array ``a``; bf16 arrays (numpy's extension
    dtype) cross through fp32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def cache_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's decode cache from the reference's (``init_cache`` /
    ``prefill_cache``, arrays as numpy), the same nesting with each leaf a
    tensor in its own dtype on ``device``: the KV families' {k, v [L, B,
    clen, KV, Hd], kpos [B, clen] int32}, the ssm family's {ssm: {conv,
    ssm}} and the hybrid's {rec: {r{j}: {conv, h}}, k, v, kpos[, tail: a
    list of {conv, h}]}.  Any other top level raises."""
    layouts = ({"k", "v", "kpos"}, {"ssm"}, {"rec", "k", "v", "kpos"},
               {"rec", "k", "v", "kpos", "tail"})
    if set(tree) not in layouts:
        raise KeyError(f"not a decode cache of the reference's: "
                       f"{sorted(tree)}")

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [carry(v) for v in node]
        return _tensor(node).to(device)

    return carry(tree)


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``params_from_jax``: a nested dict of fp32 numpy arrays
    in the reference's tree layout (the hybrid's ``tail`` a list)."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return _listify(tree)


def _state_from_jax(opt, named_params, state: Dict[str, Any],
                    keys) -> None:
    cache = torch_dtype(opt.cfg.cache_dtype)
    leaves = state["leaves"]
    for name, p in named_params:
        node = leaves
        for part in name.split("."):
            node = _child(node, part)
        unknown = sorted(set(node) - set(keys))
        if unknown:
            raise KeyError(f"{name}: state keys {unknown} are not carried "
                           f"by the port's {type(opt).__name__}")
        opt.state[p] = {
            k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy()).to(
                device=p.device, dtype=_state_dtype(k, cache))
            for k, v in node.items()}
    opt.count = int(np.asarray(state["count"]))
    if "pending_at" in state:
        base.set_pending_at(opt, int(np.asarray(state["pending_at"])))


def muon_state_from_jax(opt, named_params, state: Dict[str, Any]) -> None:
    """Install the reference's Muon state into the port's ``Muon`` ``opt``
    (built over ``named_params``), as ``shampoo_state_from_jax`` does."""
    _state_from_jax(opt, named_params, state, MUON_STATE_KEYS)


def shampoo_state_from_jax(opt, named_params, state: Dict[str, Any]) -> None:
    """Install the reference's Shampoo state into the port's ``Shampoo``
    ``opt`` (built over ``named_params``): ``state`` is what
    ``make_shampoo(...).init``/``update`` return, {"leaves": a tree of
    per-parameter dicts shaped like the parameters, "count": int[,
    "pending_at": int]}, arrays as numpy (bf16 allowed).  The cached
    inverse roots and their pending twins take the port's
    ``cache_dtype``, the telemetry int32/int8, everything else fp32; a
    key the port does not carry raises."""
    _state_from_jax(opt, named_params, state, SHAMPOO_STATE_KEYS)
