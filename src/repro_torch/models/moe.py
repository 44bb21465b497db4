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

On a mesh (``place``, a ``Place``; the model passes its own) the layer
computes what one process computes on the global batch:

  * routing: each rank routes its own rows; under ``"global"`` it
    all-gathers the chosen experts ([T, K] int64; the gates stay with
    their rows) over the batch group in row order, so every rank builds
    the same slot table with C = ``capacity(m, T_global)``, and keeps
    the slots of its own rows' tokens (``_own_slots``): within an
    expert the slots follow the token order, so a rank's are one run of
    each expert's slots, packed to the longest run.  ``"per_sample"``
    routes each sequence alone and gathers nothing;
  * experts: under "tp" (``place.tp``) the rank runs its own experts on
    its rows' slots (``split == "experts"``, expert parallelism) or
    every expert on its columns of ``w_gate``/``w_up`` and rows of
    ``w_down`` (``split == "expert_mlp"``); the tokens and the gates
    enter through ``collectives.copy_to`` and the partial outputs are
    summed over the model axis (``collectives.reduce_from``), as
    ``layers.mlp`` does; the router runs on the replicated activations,
    so its gradient needs no model sum;
  * the aux loss: f_e and P_e are means over the global batch, one SUM
    all-reduce of the counts and probability sums over the batch group;
    the gradient through P_e is scaled by the group's size, so the
    Trainer's mean of the ranks' gradients is one process's.
"""
from __future__ import annotations

import contextlib
from typing import Any, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import collectives
from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models import layers as L


class Rows(NamedTuple):
    """A rank's rows of the global batch: the group of the ranks holding
    distinct rows, its size and the rank's index in it (its rows are
    block ``index`` of the batch)."""

    group: Any
    size: int
    index: int


class Place(NamedTuple):
    """A rank's place for the moe layer (module docstring): its ``rows``
    (None: the whole batch), its model-axis place under "tp" (``tp``,
    None otherwise) and which expert dim ``tp`` splits ("experts" or
    "expert_mlp")."""

    rows: Optional[Rows]
    tp: Optional[L.TP]
    split: str


_DROPS: List[list] = []


@contextlib.contextmanager
def count_drops():
    """Record (assignments, dropped) of every dispatch in the block, the
    dropped count a device scalar (no synchronization), over the slot
    table the rank builds: the global batch's under "global", its own
    sequences' under "per_sample"; yields the list."""
    seen: list = []
    _DROPS.append(seen)
    try:
        yield seen
    finally:
        _DROPS.remove(seen)


def _record_drops(slot_of: torch.Tensor, E: int, C: int) -> None:
    for seen in _DROPS:
        seen.append((slot_of.numel(), (slot_of == E * C).sum()))


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
    combine gathers through.  With ``gates`` None, ``gate_for_slot`` is
    None."""
    *lead, T, K = topi.shape
    dev = topi.device
    flat_e = topi.reshape(*lead, T * K)
    ar = torch.arange(T * K, device=dev)
    flat_t = (ar // K).expand_as(flat_e)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    st = torch.gather(flat_t, -1, order)
    # position within expert = index - first index of this expert id
    first = torch.searchsorted(se.contiguous(), se.contiguous(),
                               side="left")
    pos = ar - first
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(se, E * C))
    tok_for_slot = torch.zeros(*lead, E * C + 1, dtype=torch.int64,
                               device=dev).scatter_(-1, slot, st)
    slot_of = torch.empty_like(slot).scatter_(-1, order, slot)
    if gates is None:
        return tok_for_slot[..., :-1], None, slot_of.reshape(*lead, T, K)
    sg = torch.gather(gates.reshape(*lead, T * K), -1, order)
    gate_for_slot = torch.zeros(*lead, E * C + 1, dtype=torch.float32,
                                device=dev).scatter_(
        -1, slot, torch.where(keep, sg.float(), torch.zeros_like(sg)))
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


def _aux(probs_full: torch.Tensor, topi: torch.Tensor, m: MoEConfig,
         rows: Optional[Rows]) -> torch.Tensor:
    """The Switch loss E * sum_e f_e * P_e * coef over the global batch:
    with ``rows``, the counts and probability sums SUM all-reduced over
    the batch group (one call), the gradient through P_e scaled by its
    size (module docstring)."""
    E = m.num_experts
    # one-hot by comparison: F.one_hot reads the index range back to the
    # host on the card, a synchronization per layer
    onehot = (topi[..., None] == torch.arange(E, device=topi.device)).float()
    if rows is None:
        f_e = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
        P_e = torch.mean(probs_full, dim=(0, 1))
    else:
        counts = torch.sum(onehot, dim=(0, 1, 2))
        psum = torch.sum(probs_full, dim=(0, 1))
        tot = collectives.all_reduce(torch.stack([counts, psum.detach()]),
                                     "sum", rows.group, kind="moe")
        T = topi.shape[0] * topi.shape[1] * rows.size
        f_e = tot[0] / T
        P_e = (tot[1] + rows.size * (psum - psum.detach())) / T
    return E * torch.sum(f_e * P_e) * m.router_aux_loss_coef


def _own_slots(topi: torch.Tensor, gates: torch.Tensor, t0: int, e0: int,
               e1: int, E: int, C: int):
    """The global dispatch of ``topi`` [T, K] (every row of the batch, in
    row order) cut to the slots of this rank's tokens, rows [t0, t0 +
    T_own) with ``gates`` [T_own, K], at experts [e0, e1) -> (tok
    [Ew*Cw] (own token index), gate [Ew*Cw], slot_of [T_own, K], an
    assignment that is dropped or at another expert at Ew*Cw).

    Within an expert the slots follow the token order, so the own
    tokens' slots of expert e are one run [a_e, b_e): they are packed to
    Cw, the longest run of [e0, e1) (read to the host), and the other
    rows' slots are not computed."""
    T_own, K = gates.shape
    dev = topi.device
    _, _, slot_of = _dispatch_indices(topi, None, E, C)
    _record_drops(slot_of, E, C)
    ids = torch.arange(E, device=dev)
    before = (topi[:t0, :, None] == ids).sum(dim=(0, 1))
    mine = (topi[t0:t0 + T_own, :, None] == ids).sum(dim=(0, 1))
    a = torch.clamp(before, max=C)
    n = torch.clamp(before + mine, max=C) - a
    Ew = e1 - e0
    Cw = max(int(n[e0:e1].max()), 1)
    own = slot_of[t0:t0 + T_own]
    e = own // C
    ok = (own < E * C) & (e >= e0) & (e < e1)
    at = (e - e0).clamp(0, Ew - 1) * Cw + own - e * C \
        - a[e.clamp(max=E - 1)]
    slot = torch.where(ok, at, Ew * Cw)
    flat = slot.reshape(-1)
    tok = torch.zeros(Ew * Cw + 1, dtype=torch.int64, device=dev).scatter_(
        0, flat, torch.arange(T_own * K, device=dev) // K)
    gate = torch.zeros(Ew * Cw + 1, dtype=torch.float32, device=dev) \
        .scatter_(0, flat, torch.where(ok, gates.float(),
                                       torch.zeros((), device=dev))
                  .reshape(-1))
    return tok[:-1], gate[:-1], slot, Cw


def _ffn(params, x: torch.Tensor, topi: torch.Tensor, gates: torch.Tensor,
         m: MoEConfig, place: Optional[Place]) -> torch.Tensor:
    """The dispatch, experts and combine -> fp32 y [B, S, D]; on a mesh,
    of the rank's rows (module docstring)."""
    B, S, D = x.shape
    E = m.num_experts
    tp = None if place is None else place.tp
    E_own = params["w_gate"].shape[0]
    e0 = 0
    if E_own != E:
        if tp is None or place.split != "experts":
            raise ValueError(f"{E_own} of {E} experts on a rank without "
                             f"expert parallelism")
        e0 = tp.index * E_own
    if tp is not None:
        x = collectives.copy_to(x, tp.group)
        gates = collectives.copy_to(gates, tp.group)
    if m.dispatch == "per_sample":
        C = capacity(m, S)
        tok, gate, slot_of = _dispatch_indices(topi, gates, E, C)
        _record_drops(slot_of, E, C)
        if E_own != E:
            lo, hi = e0 * C, (e0 + E_own) * C
            tok, gate = tok[:, lo:hi], gate[:, lo:hi]
            slot_of = torch.where((slot_of >= lo) & (slot_of < hi),
                                  slot_of - lo, E_own * C)
        xg = _Dispatch.apply(x, tok, slot_of)
        y_e = _experts(params, xg.reshape(B, E_own, C, D), x.dtype)
        y = _combine(y_e.reshape(B, E_own * C, D), gate, slot_of)
    elif place is None:
        # ---- global dispatch over all B*S tokens (baseline)
        T = B * S
        C = capacity(m, T)
        tok, gate, slot_of = _dispatch_indices(
            topi.reshape(T, -1), gates.reshape(T, -1), E, C)
        _record_drops(slot_of, E, C)
        xg = _Dispatch.apply(x.reshape(T, D), tok, slot_of).reshape(E, C, D)
        y_e = _experts(params, xg, x.dtype).reshape(E * C, D)
        y = _combine(y_e, gate, slot_of).reshape(B, S, D)
    else:
        T = B * S
        rows = place.rows
        flat, t0 = topi.reshape(T, -1), 0
        if rows is not None:
            flat = collectives.all_gather(flat, rows.group, kind="moe")
            t0 = rows.index * T
        tok, gate, slot_of, Cw = _own_slots(
            flat, gates.reshape(T, -1), t0, e0, e0 + E_own, E,
            capacity(m, flat.shape[0]))
        xg = _Dispatch.apply(x.reshape(T, D), tok, slot_of)
        y_e = _experts(params, xg.reshape(E_own, Cw, D), x.dtype)
        y = _combine(y_e.reshape(E_own * Cw, D), gate, slot_of)
        y = y.reshape(B, S, D)
    return y if tp is None else collectives.reduce_from(y, tp.group)


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            place: Optional[Place] = None):
    """x [B, S, D] -> (y [B, S, D], aux_loss fp32 scalar); on a mesh,
    the rank's rows and share of the experts as ``place`` says (module
    docstring)."""
    m: MoEConfig = cfg.moe
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    probs_full = torch.softmax(logits, dim=-1)
    topv, topi = top_k(logits, m.num_experts_per_tok)  # [B, S, K]
    gates = torch.softmax(topv, dim=-1)  # renormalize over selected
    # ---- aux load-balance loss (Switch): E * sum_e f_e * P_e
    aux = _aux(probs_full, topi, m, None if place is None else place.rows)
    return _ffn(params, x, topi, gates, m, place).to(x.dtype), aux
