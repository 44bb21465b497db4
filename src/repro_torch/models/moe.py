"""Mixture-of-Experts FFN with capacity-based sort dispatch (counterpart of
``repro/models/moe.py``).

Top-k routing -> flatten assignments -> stable sort by expert -> fixed
capacity C = ceil(k*T/E) * capacity_factor slots per expert -> gather,
batched per-expert SwiGLU, weighted combine.  The Switch-style
load-balancing loss is returned beside the output.

The reference's semantics, kept exactly:

  * top-k ties go to the lower expert index (``lax.top_k``): the port
    takes the first k of a stable descending sort, since ``torch.topk``
    on CUDA promises no order among equal logits;
  * C = ``max(int(ceil(K*T/E) * capacity_factor), 4)``, Python's
    truncation of the float; assignments past C land in a scratch slot
    E*C and are dropped, and unfilled slots hold token 0 with gate 0;
  * ``dispatch="global"`` routes all B*S tokens together, so a lane's
    output depends on its batch-mates once an expert overflows (in a
    decode batch too); ``"per_sample"`` dispatches within each sequence.

The combine is a gather, not the reference's scatter-add: each token sums
its K slots' weighted outputs in rank order (a dropped assignment reads a
zero row), and the dispatch gather's backward sums each token's K slot
gradients the same way (``_Dispatch``).  Neither needs an atomic add, so
both passes are the same bits run to run on the card; they sum in
another order than the reference, so they match it to fp32 rounding.
The expert products run in the compute dtype with fp32 accumulation,
silu(gate) * up in fp32, and the combine in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models import layers as L


def moe_shapes(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


def moe_axes(cfg: ModelConfig):
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
    }


def init_moe(gen: torch.Generator, cfg: ModelConfig, num_layers: int,
             dtype, device=None):
    """Layer-stacked MoE parameters [L, ...]: the fp32 router and the
    experts in ``dtype``, fan-in scaled (the reference's ``dense_init``
    over the per-layer shape)."""
    out = {}
    for name, shp in moe_shapes(cfg).items():
        dt = torch.float32 if name == "router" else dtype
        out[name] = L.dense_init(gen, (num_layers,) + shp, -2, dt, device)
    return out


def capacity(m: MoEConfig, tokens: int) -> int:
    """Per-expert slot budget for ``tokens`` tokens routed together."""
    K, E = m.num_experts_per_tok, m.num_experts
    return max(int(-(-K * tokens // E) * m.capacity_factor), 4)


def top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis in
    descending order, ties by the lower index, as ``lax.top_k``."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(topi: torch.Tensor, gates: torch.Tensor, E: int,
                      C: int):
    """[..., T, K] assignments -> (tok_for_slot [..., E*C], gate_for_slot
    [..., E*C], slot_of [..., T, K]).

    Stable sort by expert id + fixed per-expert capacity C; an overflow
    assignment lands in the scratch slot E*C, which is dropped.  Leading
    dims are independent dispatches (``per_sample``).  ``slot_of`` is
    each assignment's slot (E*C when dropped), the inverse map the
    combine gathers through."""
    *lead, T, K = topi.shape
    dev = topi.device
    flat_e = topi.reshape(*lead, T * K)
    ar = torch.arange(T * K, device=dev)
    flat_t = (ar // K).expand_as(flat_e)
    flat_g = gates.reshape(*lead, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    st = torch.gather(flat_t, -1, order)
    sg = torch.gather(flat_g, -1, order)
    # position within expert = index - first index of this expert id
    first = torch.searchsorted(se.contiguous(), se.contiguous(),
                               side="left")
    pos = ar - first
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(se, E * C))
    tok_for_slot = torch.zeros(*lead, E * C + 1, dtype=torch.int64,
                               device=dev).scatter_(-1, slot, st)
    gate_for_slot = torch.zeros(*lead, E * C + 1, dtype=torch.float32,
                                device=dev).scatter_(
        -1, slot, torch.where(keep, sg.float(), torch.zeros_like(sg)))
    slot_of = torch.empty_like(slot).scatter_(-1, order, slot)
    return (tok_for_slot[..., :-1], gate_for_slot[..., :-1],
            slot_of.reshape(*lead, T, K))


def _experts(params, xg: torch.Tensor, dtype) -> torch.Tensor:
    """Per-expert SwiGLU of xg [..., E, C, D] -> [..., E, C, D]."""
    gate_h = torch.matmul(xg, params["w_gate"])
    up_h = torch.matmul(xg, params["w_up"])
    h = (F.silu(gate_h.float()) * up_h.float()).to(dtype)
    return torch.matmul(h, params["w_down"])


def _sum_slots(rows: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
    """rows [..., E*C, D], slot_of [..., T, K] -> [..., T, D]: each
    token's K slot rows summed in rank order, a dropped assignment (slot
    E*C) reading a zero row.  A gather: no atomic add."""
    rows = F.pad(rows, (0, 0, 0, 1))
    T, K = slot_of.shape[-2:]
    lead = slot_of.shape[:-2]
    idx = slot_of.reshape(*lead, T * K, 1).expand(*lead, T * K,
                                                  rows.shape[-1])
    picked = torch.gather(rows, -2, idx)
    return picked.reshape(*lead, T, K, rows.shape[-1]).sum(-2)


class _Dispatch(torch.autograd.Function):
    """xg = x[tok] ([..., T, D] -> [..., E*C, D]) whose backward is a
    gather too: each token's gradient sums its K slots' (``_sum_slots``).
    Autograd's own backward of the gather adds every slot's row into its
    token's with ``index_put_``, which serializes on token 0: every
    unfilled slot points at it (at least 8,192 of granite's 40,960 slots
    a layer at batch 8 x 512).  The unfilled slots' gradients are exactly zero
    (the combine reads none of their outputs), so skipping them changes
    no value."""

    @staticmethod
    def forward(ctx, x, tok, slot_of):
        ctx.save_for_backward(slot_of)
        return torch.gather(x, -2, tok[..., None].expand(
            *tok.shape, x.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        (slot_of,) = ctx.saved_tensors
        return _sum_slots(grad, slot_of), None, None


def _combine(y_e: torch.Tensor, gate_for_slot: torch.Tensor,
             slot_of: torch.Tensor) -> torch.Tensor:
    """y_e [..., E*C, D], gates [..., E*C], slot_of [..., T, K] -> fp32
    [..., T, D]: each token's weighted slot outputs summed over its K
    assignments."""
    return _sum_slots(y_e.float() * gate_for_slot[..., None], slot_of)


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, D] -> (y [B, S, D], aux_loss fp32 scalar)."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.num_experts_per_tok
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    probs_full = torch.softmax(logits, dim=-1)
    topv, topi = top_k(logits, K)  # [B, S, K]
    gates = torch.softmax(topv, dim=-1)  # renormalize over selected

    # ---- aux load-balance loss (Switch): E * sum_e f_e * P_e
    # one-hot by comparison: F.one_hot reads the index range back to the
    # host on the card, a synchronization per layer
    onehot = (topi[..., None] == torch.arange(E, device=x.device)).float()
    f_e = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
    P_e = torch.mean(probs_full, dim=(0, 1))
    aux = E * torch.sum(f_e * P_e) * m.router_aux_loss_coef

    if m.dispatch == "per_sample":
        C = capacity(m, S)
        tok, gate, slot_of = _dispatch_indices(topi, gates, E, C)
        xg = _Dispatch.apply(x, tok, slot_of)
        y_e = _experts(params, xg.reshape(B, E, C, D), x.dtype)
        y = _combine(y_e.reshape(B, E * C, D), gate, slot_of)
        return y.to(x.dtype), aux

    # ---- global dispatch over all B*S tokens (baseline)
    T = B * S
    C = capacity(m, T)
    tok, gate, slot_of = _dispatch_indices(topi.reshape(T, K),
                                           gates.reshape(T, K), E, C)
    xg = _Dispatch.apply(x.reshape(T, D), tok, slot_of).reshape(E, C, D)
    y_e = _experts(params, xg, x.dtype).reshape(E * C, D)
    y = _combine(y_e, gate, slot_of)
    return y.reshape(B, S, D).to(x.dtype), aux
