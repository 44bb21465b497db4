"""Decoder model, dense family (counterpart of
``repro/models/transformer.py``).

``Model`` is an ``nn.Module`` whose parameters are the fp32 MASTER copies,
layer-stacked with the reference's names and shapes (``layers.attn.wq``:
[L, d, H, hd], ...).  ``logical_axes()`` gives the same axis tuples, so
Muon's matrix views and buckets come out as in the reference.  The
forward pass casts every master to ``param_dtypes()`` (bf16 matrices,
fp32 norms) on the way in, and autograd returns fp32 gradients to the
masters.

  param_shapes()       name -> shape (no tensors, any size)
  logical_axes()       name -> logical-axis tuple
  param_dtypes()       name -> compute dtype of the forward pass
  cast_params()        name -> master cast to its compute dtype
  forward(batch)       -> (logits [B, S, V_padded] fp32, aux)
  loss(batch)          -> (scalar next-token CE, metrics)

The vocabulary pads to a multiple of 16; pad logits are masked out of
the CE.  The reference remats each block (``jax.checkpoint``); at the
sizes this port trains, activations fit without it.  The moe, ssm,
hybrid, vlm and audio families and decode are ported with later slices
(ROADMAP.md Queue 1 items 9-10).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

VOCAB_PAD_MULTIPLE = 16  # pad odd vocab tables so TP sharding divides


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def param_specs(cfg: ModelConfig) -> Dict[str, Tuple[tuple, tuple, str]]:
    """name -> (shape, logical axes, dtype name) of every parameter, in the
    order the model registers them."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is ported with a later slice "
            "(ROADMAP.md Queue 1 item 10); only 'dense' runs so far")
    if cfg.tie_embeddings:
        raise NotImplementedError("tied embeddings are ported with a later "
                                  "slice (ROADMAP.md Queue 1 item 10)")
    V, d, Lyr = padded_vocab(cfg), cfg.d_model, cfg.num_layers
    specs = {
        "final_ln": ((d,), ("embed",), "float32"),
        "embed": ((V, d), ("vocab", "embed"), cfg.emb_dtype),
        "head": ((d, V), ("embed", "vocab"), cfg.emb_dtype),
        "layers.ln1": ((Lyr, d), ("layers", "embed"), "float32"),
        "layers.ln2": ((Lyr, d), ("layers", "embed"), "float32"),
    }
    a_shapes, a_axes = attn.attention_shapes(cfg), attn.attention_axes(cfg)
    for k, shp in a_shapes.items():
        dt = "float32" if k.endswith("norm") else cfg.dtype
        specs[f"layers.attn.{k}"] = ((Lyr,) + shp, ("layers",) + a_axes[k],
                                     dt)
    m_shapes, m_axes = L.mlp_shapes(cfg), L.mlp_axes(cfg)
    for k, shp in m_shapes.items():
        specs[f"layers.mlp.{k}"] = ((Lyr,) + shp, ("layers",) + m_axes[k],
                                    cfg.dtype)
    return specs


def _init_values(cfg: ModelConfig, gen: torch.Generator, device):
    """Initial values in each parameter's compute dtype (as the reference's
    ``Model.init`` makes them)."""
    emb_dt, dt = torch_dtype(cfg.emb_dtype), torch_dtype(cfg.dtype)
    V, d, Lyr = padded_vocab(cfg), cfg.d_model, cfg.num_layers
    vals = {
        "final_ln": torch.zeros((d,), device=device),
        "embed": L.embed_init(gen, (V, d), emb_dt, device),
        "head": L.dense_init(gen, (d, V), -2, emb_dt, device),
        "layers.ln1": torch.zeros((Lyr, d), device=device),
        "layers.ln2": torch.zeros((Lyr, d), device=device),
    }
    for k, v in attn.init_attention(gen, cfg, Lyr, dt, device).items():
        vals[f"layers.attn.{k}"] = v
    for k, shp in L.mlp_shapes(cfg).items():
        vals[f"layers.mlp.{k}"] = L.dense_init(gen, (Lyr,) + shp, -2, dt,
                                               device)
    return vals


class Model(nn.Module):
    """Dense decoder with fp32 master parameters (see module docstring).

    ``device`` defaults to CUDA (``device.resolve_device``); ``seed``
    seeds the ``torch.Generator`` of the initial values.
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.padded_vocab = padded_vocab(cfg)
        self._specs = param_specs(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        vals = _init_values(cfg, gen, dev)
        for name in self._specs:
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(
                leaf, nn.Parameter(vals[name].to(torch.float32)))

    # ------------------------------------------------------------- layout

    def param_shapes(self) -> Dict[str, tuple]:
        return {k: s for k, (s, _, _) in self._specs.items()}

    def logical_axes(self) -> Dict[str, tuple]:
        return {k: a for k, (_, a, _) in self._specs.items()}

    def param_dtypes(self) -> Dict[str, torch.dtype]:
        return {k: torch_dtype(d) for k, (_, _, d) in self._specs.items()}

    def cast_params(self) -> Dict[str, torch.Tensor]:
        """Masters cast to their compute dtypes (differentiable)."""
        dts = self.param_dtypes()
        return {k: p.to(dts[k]) for k, p in self.named_parameters()}

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy ``params`` (name -> tensor, any float dtype) into the
        masters; names and shapes must match exactly."""
        own = dict(self.named_parameters())
        if set(params) != set(own):
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(set(own) - set(params))}, unexpected "
                           f"{sorted(set(params) - set(own))}")
        for k, v in params.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(v)

    # ------------------------------------------------------------- pieces

    def _embed_tokens(self, params, tokens):
        cfg = self.cfg
        x = params["embed"][tokens]
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return x.to(torch_dtype(cfg.dtype))

    def _lm_logits(self, params, x):
        cfg = self.cfg
        x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
        logits = L.softcap((x @ params["head"]).float(), cfg.logits_softcap)
        if self.padded_vocab != cfg.vocab_size:  # mask pad rows out of CE
            iota = torch.arange(self.padded_vocab, device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits,
                                 torch.full((), L.NEG_INF,
                                            device=logits.device))
        return logits

    def _backbone(self, params, x, positions):
        """x [B, S, D] -> (x, aux_loss); one loop over the stacked layers."""
        cfg = self.cfg
        lay = {k[len("layers."):]: v for k, v in params.items()
               if k.startswith("layers.")}
        for i in range(cfg.num_layers):
            p = {k: v[i] for k, v in lay.items()}
            a = {k[len("attn."):]: v for k, v in p.items()
                 if k.startswith("attn.")}
            m = {k[len("mlp."):]: v for k, v in p.items()
                 if k.startswith("mlp.")}
            h, _ = attn.attend(a, L.rms_norm(x, p["ln1"], cfg.norm_eps),
                               positions, cfg)
            x = x + h
            x = x + L.mlp(m, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
        return x, 0.0

    def _positions(self, x):
        B, S = x.shape[0], x.shape[1]
        return torch.arange(S, dtype=torch.int32,
                            device=x.device).expand(B, S)

    # ------------------------------------------------------------- public

    def forward(self, batch, params: Optional[Dict] = None):
        """Full-sequence fp32 logits over the padded vocab, and aux."""
        params = self.cast_params() if params is None else params
        x = self._embed_tokens(params, batch["tokens"])
        x, aux = self._backbone(params, x, self._positions(x))
        return self._lm_logits(params, x), aux

    def loss(self, batch, params: Optional[Dict] = None,
             chunk: Optional[int] = None):
        """Next-token CE with seq-chunked logits -> (loss, metrics)."""
        params = self.cast_params() if params is None else params
        tokens = batch["tokens"]
        x = self._embed_tokens(params, tokens)
        x, aux = self._backbone(params, x, self._positions(x))
        ce = self._ce_from_hidden(params, x, tokens, chunk)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux,
                      "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}

    def prefill(self, *args, **kwargs):
        raise NotImplementedError(
            "serving prefill is ported with the serving slice "
            "(ROADMAP.md Queue 1 item 9)")

    init_cache = decode_step = prefill

    def _ce_from_hidden(self, params, x, tokens,
                        chunk: Optional[int] = None):
        """Chunked next-token CE given backbone output x [B, S, D]: the LM
        head runs per sequence chunk, so at most [B, chunk, V] logits
        exist at once."""
        chunk = chunk or self.cfg.loss_chunk
        B = x.shape[0]
        tg = tokens[:, 1:]
        xs = x[:, :-1]
        Sm1 = xs.shape[1]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for s0 in range(0, Sm1, chunk):
            logits = self._lm_logits(params, xs[:, s0:s0 + chunk])
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1,
                                tg[:, s0:s0 + chunk, None].long())[..., 0]
            total = total + torch.sum(nll)
        return total / (B * Sm1)
