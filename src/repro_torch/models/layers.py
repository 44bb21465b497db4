"""Shared model layers: init helpers, norms, rotary embeddings, MLPs
(counterpart of ``repro/models/layers.py``).

Parameters are plain tensors in a name -> tensor dict; every function
takes the tensors it needs and keeps the reference's casts.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

NEG_INF = -1e30  # finite mask: -inf breaks the softmax max-subtraction


# ---------------------------------------------------------------------------
# init helpers (same distributions as the reference; torch.Generator bits)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = shape[in_axis]
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) / np.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    # std 1/sqrt(d_model): unit-scale lookups after gemma-style sqrt(d)
    # input scaling, O(1) logits under tied embeddings
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) / np.sqrt(shape[-1])).to(dtype)


# ---------------------------------------------------------------------------
# norms, rotary embeddings


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Apply RoPE to x [..., S, H, Hd] with integer positions [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)


def mlp_shapes(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": (d, f), "w_down": (f, d)}
    if cfg.mlp_act == "silu":  # SwiGLU has a gate projection
        p["w_gate"] = (d, f)
    return p


def mlp_axes(cfg: ModelConfig):
    p = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.mlp_act == "silu":
        p["w_gate"] = ("embed", "mlp")
    return p


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = x @ params["w_up"]
    if cfg.mlp_act == "silu":
        gate = F.silu((x @ params["w_gate"]).float())
        h = (gate * up.float()).to(x.dtype)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# misc


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def causal_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Additive bias [.., Sq, Sk]: 0 where attendable, ~-inf otherwise."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window and window > 0:
        ok &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, neg)
