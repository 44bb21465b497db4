"""Mamba-1 selective state-space block, falcon-mamba-7b (counterpart of
``repro/models/ssm.py``).

Train path: the reference's chunked selective scan.  The sequence runs in
chunks of ``SCAN_CHUNK`` steps, each chunk a sequential scan from the
[B, d_inner, d_state] fp32 state the previous chunk left; the tail chunk
is padded with dA = 1, dBx = 0, which leave the state as it was.  Each
chunk runs under ``torch.utils.checkpoint``, as the reference runs each
under ``jax.checkpoint``: backward keeps only the boundary states and
recomputes a chunk's per-step states.  The chunk also recomputes its own
dA = exp(dt A) and dBx = dt x B from dt, x and B (the same elementwise
values the reference computes for the whole sequence), so the
[B, S, d_inner, d_state] tensors exist one chunk at a time, in forward
and backward alike.  Decode path: one recurrence step against a carried
(conv, ssm) state.

Tensor parallelism (``mamba_block(..., tp=)``, ``layers.TP``): the rules
split every ``mlp`` dim, ``d_inner``, over the model axis, and each rank
runs its own block of channels.  The input enters through
``collectives.copy_to``; ``conv_w``/``conv_b``, ``dt_proj``'s columns,
``dt_bias``, ``A_log``, ``D``, the scan and the ``z`` gate are the
rank's channels and need no collective; ``out_proj``'s rows give a
partial output that ``collectives.reduce_from`` sums.  Two leaves need
more:

  x_proj   [d_inner, dt_rank + 2 d_state] split on its rows: xc @ x_proj
           is a partial sum over the rank's channels, and every rank needs
           the whole sum (its ``dt_proj`` columns take dt_in, all of its
           channels take B and C), so it is summed forward AND backward
           (``reduce_from``, then ``copy_to``, kind "tp_sum"), in
           ``_ssm_params``, outside the scan's checkpointed chunks;
  in_proj  [d, 2 d_inner] holds [xin | z] side by side, and the rules
           split its columns into contiguous blocks (on a model axis of 2
           rank 0's block is all of xin): it is gathered whole on use
           (``gather_from``, kind "tp_gather", whose backward is a
           reduce-scatter) and the rank takes its channels of each half.

The scan is plain PyTorch: the reference's is ``lax.scan``, no Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import collectives
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

SCAN_CHUNK = 16
#: the parameters kept in fp32 whatever the compute dtype
FP32 = ("dt_bias", "A_log", "D")


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def mamba_shapes(cfg: ModelConfig):
    d, di, ds = cfg.d_model, _d_inner(cfg), cfg.ssm.state_dim
    dtr, dc = _dt_rank(cfg), cfg.ssm.conv_dim
    return {"in_proj": (d, 2 * di), "conv_w": (dc, di), "conv_b": (di,),
            "x_proj": (di, dtr + 2 * ds), "dt_proj": (dtr, di),
            "dt_bias": (di,), "A_log": (di, ds), "D": (di,),
            "out_proj": (di, d)}


def mamba_axes(cfg: ModelConfig):
    return {
        "in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"),
        "conv_b": ("mlp",), "x_proj": ("mlp", None),
        "dt_proj": (None, "mlp"), "dt_bias": ("mlp",),
        "A_log": ("mlp", None), "D": ("mlp",),
        "out_proj": ("mlp", "embed"),
    }


def init_mamba(gen: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
               device=None):
    """Mamba parameters with leading dims ``lead`` ((L,) stacked): the
    matrices fan-in scaled in ``dtype``, ``conv_b`` zeros in ``dtype``;
    fp32 ``dt_bias`` = softplus^-1(0.01), ``A_log`` = log(1..d_state) on
    every channel, ``D`` ones."""
    shapes = mamba_shapes(cfg)
    di, ds = _d_inner(cfg), cfg.ssm.state_dim
    out = {}
    for name in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
        out[name] = L.dense_init(gen, lead + shapes[name], -2, dtype,
                                 device)
    f32 = dict(dtype=torch.float32, device=device)
    out["conv_b"] = torch.zeros(lead + (di,), dtype=dtype, device=device)
    out["dt_bias"] = torch.log(torch.expm1(
        torch.full(lead + (di,), 0.01, **f32)))
    A = torch.arange(1, ds + 1, **f32).expand(lead + (di, ds))
    out["A_log"] = torch.log(A).contiguous()
    out["D"] = torch.ones(lead + (di,), **f32)
    return out


def _conv(xin, w, b, dc: int):
    """Causal depthwise conv along seq in ``xin``'s dtype, the reference's
    sum of shifted products; xin [B, S, C], w [dc, C]."""
    S = xin.shape[1]
    xpad = F.pad(xin, (0, 0, dc - 1, 0))
    return sum(xpad[:, i:i + S, :] * w[i] for i in range(dc)) + b


def _ssm_params(params, xc, cfg: ModelConfig, tp=None):
    """xc [B, S, di] (post-conv) -> fp32 (dt [B,S,di], B [B,S,ds],
    C [B,S,ds]); with ``tp`` the rank's channels of xc and dt."""
    ds, dtr = cfg.ssm.state_dim, _dt_rank(cfg)
    proj = (xc @ params["x_proj"]).float()  # [B, S, dtr + 2 ds]
    if tp is not None:
        # a partial sum over the rank's channels whose whole every rank's
        # consumers take: summed forward and backward (module docstring)
        proj = collectives.copy_to(
            collectives.reduce_from(proj, tp.group, "tp_sum"), tp.group,
            "tp_sum")
    dt_in, Bmat, Cmat = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_in @ params["dt_proj"].float() + params["dt_bias"])
    return dt, Bmat, Cmat


def _discretize(dt, xf, Bmat, A):
    """(dA, dBx) [B, S, di, ds] from dt, xf [B, S, di], B [B, S, ds] and
    A = -exp(A_log) [di, ds]."""
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xf)[..., None] * Bmat[..., None, :]
    return dA, dBx


def _scan_chunk(h, dA, dBx, Cmat):
    """Sequential scan within one chunk from h [B, di, ds] -> (h, y
    [B, c, di]).  The steps are ``unbind`` views: backward stacks their
    gradients once, where indexing each step would zero-fill and add a
    chunk-sized gradient a step."""
    hs = []
    for dAt, dBxt in zip(dA.unbind(1), dBx.unbind(1)):
        h = torch.addcmul(dBxt, dAt, h)
        hs.append(h)
    y = torch.einsum("bcds,bcs->bcd", torch.stack(hs, dim=1), Cmat)
    return h, y


def _chunk(h, dt, xf, Bmat, Cmat, A):
    """One checkpointed chunk: discretize, then scan."""
    dA, dBx = _discretize(dt, xf, Bmat, A)
    return _scan_chunk(h, dA, dBx, Cmat)


def selective_scan(dt, xf, Bmat, Cmat, A, chunk: int = SCAN_CHUNK):
    """y [B, S, di] fp32 of the selective scan from a zero state: dt, xf
    [B, S, di], B, C [B, S, ds] fp32, A [di, ds].  Padded to whole chunks
    (dt = x = B = C = 0: dA = 1, dBx = 0); under autograd each chunk is
    checkpointed."""
    Bsz, S, di = dt.shape
    nchunk = -(-S // chunk)
    pad = nchunk * chunk - S
    if pad:
        dt, xf, Bmat, Cmat = (F.pad(a, (0, 0, 0, pad))
                              for a in (dt, xf, Bmat, Cmat))
    h = torch.zeros((Bsz, di, A.shape[-1]), dtype=torch.float32,
                    device=dt.device)
    grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (dt, xf, Bmat, Cmat, A))
    ys = []
    # ``split`` views: backward concatenates the chunks' gradients once
    for blk in zip(*(torch.split(a, chunk, dim=1)
                     for a in (dt, xf, Bmat, Cmat))):
        args = (h,) + blk + (A,)
        h, y = checkpoint(_chunk, *args, use_reentrant=False) if grad \
            else _chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S]


def _in_proj(params, tp):
    """``in_proj`` [d, 2 di], or with ``tp`` its columns of the rank's
    channels of xin, then of z [d, 2 di / model] (module docstring)."""
    w = params["in_proj"]
    if tp is None:
        return w
    w = collectives.gather_from(w, tp.group, -1, "tp_gather")
    di, n = w.shape[-1] // 2, params["conv_w"].shape[-1]
    lo = tp.index * n
    return torch.cat([w[..., lo:lo + n], w[..., di + lo:di + lo + n]], -1)


def mamba_block(params, x, cfg: ModelConfig, chunk: int = SCAN_CHUNK,
                tp=None):
    """x [B, S, D] -> y [B, S, D] (training / prefill); with ``tp`` on the
    rank's channels (module docstring)."""
    if tp is not None:
        x = collectives.copy_to(x, tp.group)
    xz = x @ _in_proj(params, tp)
    xin, z = torch.chunk(xz, 2, dim=-1)  # [B, S, di]
    xc = _conv(xin, params["conv_w"], params["conv_b"], cfg.ssm.conv_dim)
    xc = F.silu(xc.float()).to(x.dtype)
    dt, Bmat, Cmat = _ssm_params(params, xc, cfg, tp)
    xf = xc.float()
    y = selective_scan(dt, xf, Bmat, Cmat, -torch.exp(params["A_log"]),
                       chunk)
    y = y + params["D"] * xf
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ params["out_proj"]
    return out if tp is None else collectives.reduce_from(out, tp.group)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     lead: tuple = (), device=None):
    """{conv [*lead, B, dc - 1, di] in ``dtype``, ssm [*lead, B, di, ds]
    fp32}, zeros."""
    di, ds, dc = _d_inner(cfg), cfg.ssm.state_dim, cfg.ssm.conv_dim
    return {
        "conv": torch.zeros(lead + (batch, dc - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(lead + (batch, di, ds), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(params, x, cache, cfg: ModelConfig, tp=None):
    """x [B, 1, D] + cache -> (y [B, 1, D], the new cache's values).

    With ``tp`` on the rank's channels, the cache as the serving rules
    lay it out (``launch/sharding.py::cache_shardings``): the ssm state
    [B, di / model, ds] the rank's channels, the conv window [B, dc - 1,
    di] whole (its "model" entry falls on the dc - 1 axis, which it does
    not divide).  ``params["in_proj"]`` is then the whole leaf, which
    the caller gathers once a serving call (``Model``): every rank forms
    the whole xin and steps the whole window, then takes its channels."""
    if tp is not None:
        x = collectives.copy_to(x, tp.group)
    xz = x @ params["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)  # [B, 1, di]
    win = torch.cat([cache["conv"], xin.to(cache["conv"].dtype)], dim=1)
    own = win
    if tp is not None:
        n = params["conv_w"].shape[-1]
        own = win[..., tp.index * n:(tp.index + 1) * n]
        z = z[..., tp.index * n:(tp.index + 1) * n]
    xc = torch.einsum("bcd,cd->bd", own, params["conv_w"]) \
        + params["conv_b"]
    xc = F.silu(xc.float()).to(x.dtype)[:, None, :]
    dt, Bmat, Cmat = _ssm_params(params, xc, cfg, tp)
    dA, dBx = _discretize(dt, xc.float(), Bmat, -torch.exp(params["A_log"]))
    h = dA[:, 0] * cache["ssm"] + dBx[:, 0]
    y = torch.einsum("bds,bs->bd", h, Cmat[:, 0])[:, None, :]
    y = y + params["D"] * xc.float()
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ params["out_proj"]
    if tp is not None:
        out = collectives.reduce_from(out, tp.group)
    return out, {"conv": win[:, 1:], "ssm": h}

