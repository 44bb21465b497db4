"""Multi-head causal self-attention (counterpart of
``repro/models/attention.py``, train path).

The reference scans over KV blocks of ``KV_BLOCK`` = 1024 with an online
softmax; at the sequence lengths this port trains (512) that is a single
block, so ``_attend_core`` computes it unblocked with the same casts:
q * scale rounded to the compute dtype before Q K^T, fp32 scores and
softmax, the unnormalized probabilities rounded before P V, fp32
accumulation, one division by the fp32 row sum.  Sequences longer than one
block, sliding windows and decode are ported with the serving slice
(ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

KV_BLOCK = 1024
HEAD_PAD = 16  # pad head counts to the model-axis width for clean TP


def padded_heads(cfg: ModelConfig):
    """(H_padded, KV_padded).  Heads pad up to a multiple of HEAD_PAD with
    exactly-zero parameters: zero heads produce zero outputs AND zero
    gradients, and Newton-Schulz polar (Muon) preserves zero columns, so
    padding is inert while keeping the reference's parameter shapes."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    Hp = -(-H // HEAD_PAD) * HEAD_PAD
    kvp = Hp if KV == H else KV  # MHA pads kv with q; GQA keeps kv
    if Hp % kvp:
        raise ValueError(f"padded heads {Hp} not a multiple of kv {kvp}")
    return Hp, kvp


def attention_shapes(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = padded_heads(cfg)
    p = {"wq": (d, nh, hd), "wk": (d, nkv, hd), "wv": (d, nkv, hd),
         "wo": (nh, hd, d)}
    if cfg.qkv_bias:
        p.update(bq=(nh, hd), bk=(nkv, hd), bv=(nkv, hd))
    if cfg.qk_norm:
        p.update(q_norm=(hd,), k_norm=(hd,))
    return p


def attention_axes(cfg: ModelConfig):
    p = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        p.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        p.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return p


def init_attention(gen: torch.Generator, cfg: ModelConfig, num_layers: int,
                   dtype, device=None):
    """Layer-stacked attention parameters [L, ...]: dense weights with
    fan-in scaling, the pad heads zeroed, zero biases and norm scales."""
    nh_t, nkv_t = cfg.num_heads, cfg.num_kv_heads
    shapes = attention_shapes(cfg)
    p = {}
    for name in ("wq", "wk", "wv", "wo"):
        w = L.dense_init(gen, (num_layers,) + shapes[name], -3, dtype,
                         device)
        if name == "wo":
            w[:, nh_t:] = 0
        else:
            w[:, :, nh_t if name == "wq" else nkv_t:] = 0
        p[name] = w
    for name in ("bq", "bk", "bv"):
        if name in shapes:
            p[name] = torch.zeros((num_layers,) + shapes[name], dtype=dtype,
                                  device=device)
    for name in ("q_norm", "k_norm"):
        if name in shapes:
            p[name] = torch.zeros((num_layers,) + shapes[name],
                                  dtype=torch.float32, device=device)
    return p


def _project_qkv(params, x, positions, cfg: ModelConfig):
    """x [B, S, D] -> q [B, S, H, Hd], k/v [B, S, KV, Hd] (RoPE applied)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = L.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, KV, Hd] -> [B, S, H, Hd] by repeating each kv head."""
    return k if groups == 1 else torch.repeat_interleave(k, groups, dim=2)


def _attend_core(q, k, v, q_pos, k_pos, window: int):
    """Softmax attention in one KV block; q [B,S,H,Hd], k/v [B,Sk,KV,Hd]."""
    H, Hd = q.shape[2], q.shape[3]
    k = _expand_kv(k, H // k.shape[2])
    v = _expand_kv(v, H // v.shape[2])
    scale = 1.0 / math.sqrt(Hd)
    qs = (q.float() * scale).to(q.dtype)
    # compute-dtype operands, fp32 products and sums
    s = torch.einsum("bshk,bthk->bsht", qs.float(), k.float())
    s = s + L.causal_mask_bias(q_pos, k_pos, window)[:, :, None, :]
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.sum(p, dim=-1)
    acc = torch.einsum("bsht,bthk->bshk", p.to(q.dtype).float(), v.float())
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.to(q.dtype)


def attend(params, x, positions, cfg: ModelConfig, window=None,
           kv_block: int = KV_BLOCK):
    """Self-attention over x [B, S, D] (train path) -> (out, (k, v))."""
    w = cfg.sliding_window if window is None else window
    if x.shape[1] > kv_block or w:
        raise NotImplementedError(
            "attention over more than one KV block or a sliding window is "
            "ported with the serving slice (ROADMAP.md Queue 1 item 9)")
    q, k, v = _project_qkv(params, x, positions, cfg)
    out = _attend_core(q, k, v, positions, positions, w)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (k, v)
