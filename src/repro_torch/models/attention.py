"""Grouped-query attention with an online softmax over KV blocks
(counterpart of ``repro/models/attention.py``).

The train and prefill path (``attend``) walks the keys in blocks of
``kv_block`` with the reference's running (max, denominator, accumulator)
carries, so no [S, S] score matrix is formed, with the reference's casts:
q * scale in fp32 rounded to the compute dtype before Q K^T, fp32 scores,
the unnormalized probabilities rounded before P V, fp32 accumulation, one
division by the fp32 denominator.  A sliding window masks keys more than
``window`` positions back.  ``decode_attend`` is the one-token step
against a KV cache, which it updates in place.

Tensor parallelism (``attend(..., tp=)``): a rank holds H_padded / model
query heads (``wq``, ``bq`` and ``wo``'s head dim are its block; the
heads pad to ``HEAD_PAD`` for this).  The kv heads are replicated over
the model axis: each rank projects only the kv heads its query heads
read, and ``_expand_kv`` maps its heads onto them from the rank's global
head offset.  ``wo`` is row-parallel and ends in one SUM all-reduce over
the model axis; the input enters through ``collectives.copy_to``.  The
gradients of the replicated leaves a rank uses on its heads only
(``TP_PARTIAL``) are partial sums, which the train step sums over the
model axis.

Decode on a mesh (``decode_attend(..., tp=, kv=)``): the cache rows are
split over the ``kv_seq`` axes (``KVSeq``: the group, its size and the
rank's index; ``launch/sharding.py::cache_shardings``), so a rank holds
a block of every lane's slots with every kv head.  The new k/v row is
written only on the rank that owns its slot (``write_rows(..., kv=)``),
every other rank leaving its rows bitwise as they were.  Each rank
scores every query head over its slots (under tensor parallelism q is
all-gathered over the model axis first, kind "kv_q"), and the softmax
is combined flash-decode style over the group: a MAX all-reduce of the
row max, a SUM of exp(s - max), the normalized probabilities rounded
to q's dtype before P V, and a SUM of the fp32 partial P V (kind
"kv_seq").  Under tensor parallelism the rank then takes its own heads
into the row-parallel ``wo``, which ends in ``reduce_from`` as
``attend`` does.  The serving prefill (``attend(..., whole_kv=True)``)
projects every kv head, since the cache holds them all.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import collectives, sharding_ctx
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

KV_BLOCK = 1024
HEAD_PAD = 16  # pad head counts to the model-axis width for clean TP
INT32_MAX = torch.iinfo(torch.int32).max  # the k positions of pad keys
#: replicated over the model axis, used on a rank's heads only: under
#: tensor parallelism their gradients are partial sums over the ranks
TP_PARTIAL = ("wk", "wv", "bk", "bv", "q_norm", "k_norm")


class KVSeq(NamedTuple):
    """A rank's place on the ``kv_seq`` axes of a decode cache: the group
    the cache's slots are split over, its size, and the rank's index (it
    holds block ``index`` of every lane's slots)."""

    group: Any
    size: int
    index: int


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


def _expand_kv(k: torch.Tensor, groups: int, offset: int = 0,
               heads: Optional[int] = None) -> torch.Tensor:
    """[B, S, KV, Hd] -> [B, S, H, Hd] by repeating each kv head: query
    head j reads kv head (offset + j) // groups, ``offset`` the first
    query head's global index less ``groups`` times the first kv head's
    (a rank's heads under tensor parallelism)."""
    heads = k.shape[2] * groups if heads is None else heads
    if groups == 1 and offset == 0 and heads == k.shape[2]:
        return k
    idx = torch.div(offset + torch.arange(heads, device=k.device), groups,
                    rounding_mode="floor")
    return k.index_select(2, idx)


def _flash_attend(q, k, v, q_pos, k_pos, window: int, kv_block: int):
    """Online-softmax attention; q [B,S,H,Hd], k/v [B,Sk,KV,Hd].

    Keys shorter than one block form a single block of their own length
    (the reference pads it; the pad keys' exact zeros change no value),
    so the train path is one unpadded block."""
    B, S, H, Hd = q.shape
    Sk = k.shape[1]
    kv_block = min(kv_block, Sk)
    k = _expand_kv(k, H // k.shape[2])
    v = _expand_kv(v, H // v.shape[2])
    scale = 1.0 / math.sqrt(Hd)
    # compute-dtype operands, fp32 products and sums
    qs = (q.float() * scale).to(q.dtype).float()
    nb = -(-Sk // kv_block)
    pad = nb * kv_block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=INT32_MAX)
    m = torch.full((B, S, H), L.NEG_INF, dtype=torch.float32,
                   device=q.device)
    den = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, Hd), dtype=torch.float32, device=q.device)
    for i in range(nb):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        s = torch.einsum("bshk,bthk->bsht", qs, k[:, blk].float())
        s = s + L.causal_mask_bias(q_pos, k_pos[:, blk],
                                   window)[:, :, None, :]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bsht,bthk->bshk", p.to(q.dtype).float(), v[:, blk].float())
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.to(q.dtype)


def _rank_kv(params, tp: L.TP, cfg: ModelConfig):
    """(params with ``wk``/``wv``/``bk``/``bv`` cut to the kv heads this
    rank's query heads read, groups, offset, local heads)."""
    Hp, KVp = padded_heads(cfg)
    groups = Hp // KVp
    Hl = params["wq"].shape[-2]
    h0 = tp.index * Hl
    kv0, kv1 = h0 // groups, (h0 + Hl - 1) // groups + 1
    p = dict(params)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            p[name] = p[name].narrow(-2, kv0, kv1 - kv0)
    return p, groups, h0 - kv0 * groups, Hl


def attend(params, x, positions, cfg: ModelConfig, window=None,
           kv_block: int = KV_BLOCK, tp: Optional[L.TP] = None,
           whole_kv: bool = False):
    """Self-attention over x [B, S, D] (train / prefill) -> (out, (k, v));
    with ``tp`` on the rank's heads (module docstring), (k, v) the kv
    heads they read, or every kv head with ``whole_kv``."""
    w = cfg.sliding_window if window is None else window
    if tp is None:
        q, k, v = _project_qkv(params, x, positions, cfg)
        out = _flash_attend(q, k, v, positions, positions, w, kv_block)
        return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (k, v)
    x = collectives.copy_to(x, tp.group)
    if whole_kv:
        Hp, KVp = padded_heads(cfg)
        groups, Hl = Hp // KVp, params["wq"].shape[-2]
        offset, p = tp.index * Hl, params
    else:
        p, groups, offset, Hl = _rank_kv(params, tp, cfg)
    q, k, v = _project_qkv(p, x, positions, cfg)
    sharding_ctx.shard_activation(
        q, (None, None, "heads", None),
        (q.shape[0], q.shape[1], padded_heads(cfg)[0], q.shape[3]))
    out = _flash_attend(q, _expand_kv(k, groups, offset, Hl),
                        _expand_kv(v, groups, offset, Hl), positions,
                        positions, w, kv_block)
    h = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return collectives.reduce_from(h, tp.group), (k, v)


def write_rows(cache, slot, new, active, kv: Optional[KVSeq] = None):
    """cache [B, Sc, ...] <- new [B, 1, ...] at (b, slot[b]), in place;
    lanes with active False write their old row back (bitwise frozen).
    With ``kv`` the cache is the rank's block ``kv.index`` of Sc-slot
    blocks and ``slot`` the global slot: only the lanes whose slot lies
    in the block write, the others write an old row back."""
    if kv is not None:
        n = cache.shape[1]
        local = slot - kv.index * n
        mine = (local >= 0) & (local < n)
        slot = torch.clamp(local, 0, n - 1)
        active = mine if active is None else active & mine
    lanes = torch.arange(cache.shape[0], device=cache.device)
    row = new[:, 0].to(cache.dtype)
    if active is not None:
        gate = active.reshape((-1,) + (1,) * (row.ndim - 1))
        row = torch.where(gate, row, cache[lanes, slot])
    cache[lanes, slot] = row


def decode_attend(params, x, position, cache_k, cache_v, cache_pos, slot,
                  cfg: ModelConfig, window=None, active=None,
                  tp: Optional[L.TP] = None, kv: Optional[KVSeq] = None):
    """One-token decode: x [B, 1, D], cache_k/v [B, Sc, KV, Hd].

    ``cache_pos`` [B, Sc] holds the absolute position of each cache slot,
    already updated for the current token at ``slot`` [B] (rolling
    buffers reuse slots; empty slots hold a sentinel above any position
    and are masked by causality).  The new k/v rows are written into the
    cache at ``slot`` in place before attending.  ``active`` [B] bool:
    lanes with False keep their cache rows bitwise (they attend over their
    old rows; their output is garbage the caller masks); None means every
    lane is live.  The reference's casts: q * scale in q's dtype, fp32
    scores and softmax, the probabilities rounded before P V, fp32
    accumulation.  On a mesh (``tp``, ``kv``; module docstring) the
    caches, ``cache_pos`` and the global ``slot`` are the rank's block of
    the slots.

    Returns (out [B, 1, D], cache_k, cache_v), the caches updated.
    """
    if tp is not None:
        x = collectives.copy_to(x, tp.group)
    q, k, v = _project_qkv(params, x, position, cfg)
    w = cfg.sliding_window if window is None else window
    write_rows(cache_k, slot, k, active, kv)
    write_rows(cache_v, slot, v, active, kv)
    if tp is not None:  # every query head scores the rank's slots
        q = collectives.all_gather(q, tp.group, dim=2, kind="kv_q")
    B, _, H, Hd = q.shape
    KV = k.shape[2]
    groups = H // KV
    scale = torch.tensor(1.0 / np.sqrt(Hd), dtype=q.dtype)
    qg = (q * scale).reshape(B, 1, KV, groups, Hd)
    s = torch.einsum("bsghk,btgk->bsght", qg.float(), cache_k.float())
    bias = L.causal_mask_bias(position, cache_pos, w)  # [B, 1, Sc]
    s = s + bias[:, :, None, None, :]
    if kv is None:
        p = torch.softmax(s, dim=-1)
    else:  # the softmax over every rank's slots
        m = collectives.all_reduce(torch.amax(s, dim=-1), "max", kv.group,
                                   kind="kv_seq")
        e = torch.exp(s - m[..., None])
        den = collectives.all_reduce(torch.sum(e, dim=-1), "sum", kv.group,
                                     kind="kv_seq")
        p = e / den[..., None]
    out = torch.einsum("bsght,btgk->bsghk", p.to(q.dtype).float(),
                       cache_v.float())
    if kv is not None:
        out = collectives.all_reduce(out.contiguous(), "sum", kv.group,
                                     kind="kv_seq")
    out = out.reshape(B, 1, H, Hd).to(x.dtype)
    if tp is None:
        return (torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache_k,
                cache_v)
    Hl = params["wo"].shape[0]
    h = torch.einsum("bshk,hkd->bsd", out[:, :, tp.index * Hl:
                                          (tp.index + 1) * Hl], params["wo"])
    return collectives.reduce_from(h, tp.group), cache_k, cache_v
