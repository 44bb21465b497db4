"""RG-LRU recurrent block, RecurrentGemma (counterpart of
``repro/models/rglru.py``): a diagonal gated linear recurrence.

  r_t = sigmoid(x_t W_a + b_a)            (recurrence gate)
  i_t = sigmoid(x_t W_x + b_x)            (input gate)
  a_t = exp(c * softplus(Lambda) * (-r_t))   with c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full residual block is conv1d -> RG-LRU -> gated output (the
"Hawk"/Griffin recurrent block).  The reference runs the recurrence as
one ``lax.associative_scan`` over (a, b) pairs; here ``linear_scan`` runs
the same recurrence in ceil(log2 S) shifted passes (Hillis-Steele), with a
backward of its own: dL/dh_t = g_t + a_{t+1} dL/dh_{t+1} is the same scan
run from the end, so backward keeps only a and h, not every pass.  Plain
PyTorch: the reference's scan is no Pallas kernel.

Tensor parallelism (``rglru_block(..., tp=)``, ``layers.TP``): the rules
split the LRU width over the model axis and each rank runs its own block
of channels.  The input enters through ``collectives.copy_to`` and
``in_x``/``in_gate`` are the rank's columns; the conv, ``lam`` and the
scan are per channel; ``out_proj``'s rows give a partial output that
``collectives.reduce_from`` sums.  The gates' ``w_a``/``w_i`` [w, w] are
split on their rows, so xc @ w_a is a partial sum over every output
channel of which the rank needs its own: a reduce-scatter onto them
(``collectives.reduce_scatter_from``, kind "tp_scatter", whose backward
all-gathers the gradient), before the rank's ``b_a``/``b_i`` are added.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import collectives
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

_C = 8.0
#: the parameters kept in fp32 whatever the compute dtype
FP32 = ("b_a", "b_i", "lam")


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_shapes(cfg: ModelConfig):
    d, w, dc = cfg.d_model, _width(cfg), cfg.rglru.conv_dim
    return {"in_x": (d, w), "in_gate": (d, w), "conv_w": (dc, w),
            "conv_b": (w,), "w_a": (w, w), "b_a": (w,), "w_i": (w, w),
            "b_i": (w,), "lam": (w,), "out_proj": (w, d)}


def rglru_axes(cfg: ModelConfig):
    return {
        "in_x": ("embed", "mlp"), "in_gate": ("embed", "mlp"),
        "conv_w": (None, "mlp"), "conv_b": ("mlp",),
        "w_a": ("mlp", None), "b_a": ("mlp",),
        "w_i": ("mlp", None), "b_i": ("mlp",),
        "lam": ("mlp",), "out_proj": ("mlp", "embed"),
    }


def init_rglru(gen: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
               device=None):
    """RG-LRU parameters with leading dims ``lead``: the matrices fan-in
    scaled in ``dtype``, ``conv_b`` zeros in ``dtype``; fp32 zero gate
    biases and ``lam`` = 2 (softplus(2) ~ 2.1)."""
    shapes = rglru_shapes(cfg)
    w = _width(cfg)
    out = {}
    for name in ("in_x", "in_gate", "conv_w", "w_a", "w_i", "out_proj"):
        out[name] = L.dense_init(gen, lead + shapes[name], -2, dtype,
                                 device)
    out["conv_b"] = torch.zeros(lead + (w,), dtype=dtype, device=device)
    for name in ("b_a", "b_i"):
        out[name] = torch.zeros(lead + (w,), dtype=torch.float32,
                                device=device)
    out["lam"] = torch.full(lead + (w,), 2.0, dtype=torch.float32,
                            device=device)
    return out


def _gates(params, xc, tp=None):
    """(a, b) [B, S, w] fp32 of the recurrence h = a h + b; with ``tp``
    of the rank's channels (module docstring)."""
    def pre(w):
        p = (xc @ params[w]).float()
        return p if tp is None else collectives.reduce_scatter_from(
            p, tp.group, -1)

    r = torch.sigmoid(pre("w_a") + params["b_a"])
    i = torch.sigmoid(pre("w_i") + params["b_i"])
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xc.float())
    return a, b


def _scan(a, b, reverse: bool = False):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h = 0 (``reverse``: h_t =
    a_t h_{t+1} + b_t from the end), in ceil(log2 S) passes that each
    combine every position with the partial result k steps behind it."""
    S = a.shape[1]
    k = 1
    while k < S:
        if reverse:
            head_a, head_b = a[:, :-k], b[:, :-k]
            b = torch.cat([torch.addcmul(head_b, head_a, b[:, k:]),
                           b[:, -k:]], dim=1)
            if 2 * k < S:
                a = torch.cat([head_a * a[:, k:], a[:, -k:]], dim=1)
        else:
            tail_a, tail_b = a[:, k:], b[:, k:]
            b = torch.cat([b[:, :k], torch.addcmul(tail_b, tail_a,
                                                   b[:, :-k])], dim=1)
            if 2 * k < S:
                a = torch.cat([a[:, :k], tail_a * a[:, :-k]], dim=1)
        k *= 2
    return b


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        # dL/dh_t = g_t + a_{t+1} dL/dh_{t+1}: the scan from the end with
        # a shifted one step back (no successor after the last step)
        a_next = F.pad(a[:, 1:], (0, 0, 0, 1))
        d = _scan(a_next, g.contiguous(), reverse=True)
        h_prev = F.pad(h[:, :-1], (0, 0, 1, 0))
        return d * h_prev, d


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h [B, S, w] with h_t = a_t h_{t-1} + b_t, h_{-1} = 0, the
    recurrence of ``lax.associative_scan`` over (a, b) pairs."""
    return _LinearScan.apply(a, b)


def rglru_block(params, x, cfg: ModelConfig, tp=None):
    """x [B, S, D] -> y [B, S, D] (training / prefill); with ``tp`` on the
    rank's channels (module docstring)."""
    dc = cfg.rglru.conv_dim
    if tp is not None:
        x = collectives.copy_to(x, tp.group)
    xin = x @ params["in_x"]
    gate = x @ params["in_gate"]
    S = xin.shape[1]
    xpad = F.pad(xin, (0, 0, dc - 1, 0))
    xc = sum(xpad[:, i:i + S, :] * params["conv_w"][i] for i in range(dc))
    xc = (xc + params["conv_b"]).to(x.dtype)
    a, b = _gates(params, xc, tp)
    h = linear_scan(a, b)
    y = h * F.gelu(gate.float(), approximate="tanh")
    out = y.to(x.dtype) @ params["out_proj"]
    return out if tp is None else collectives.reduce_from(out, tp.group)


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     lead: tuple = (), device=None):
    """{conv [*lead, B, dc - 1, w] in ``dtype``, h [*lead, B, w] fp32},
    zeros."""
    w, dc = _width(cfg), cfg.rglru.conv_dim
    return {
        "conv": torch.zeros(lead + (batch, dc - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                         device=device),
    }


def rglru_decode_step(params, x, cache, cfg: ModelConfig, tp=None):
    """x [B, 1, D] + cache -> (y [B, 1, D], the new cache's values); with
    ``tp`` on the rank's channels, the conv window and h of the cache
    the rank's channels too (the serving rules split both on the
    width), the gates reduce-scattered onto them as in ``rglru_block``."""
    if tp is not None:
        x = collectives.copy_to(x, tp.group)
    xin = x @ params["in_x"]  # [B, 1, w]
    gate = x @ params["in_gate"]
    win = torch.cat([cache["conv"], xin.to(cache["conv"].dtype)], dim=1)
    xc = torch.einsum("bcd,cd->bd", win, params["conv_w"]) \
        + params["conv_b"]
    xc = xc.to(x.dtype)[:, None, :]
    a, b = _gates(params, xc, tp)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = h[:, None, :] * F.gelu(gate.float(), approximate="tanh")
    out = y.to(x.dtype) @ params["out_proj"]
    if tp is not None:
        out = collectives.reduce_from(out, tp.group)
    return out, {"conv": win[:, 1:], "h": h}
