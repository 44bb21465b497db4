"""Decoder model of every family (counterpart of
``repro/models/transformer.py``).

``Model`` is an ``nn.Module`` whose parameters are the fp32 MASTER copies,
layer-stacked with the reference's names and shapes (``layers.attn.wq``:
[L, d, H, hd], ...).  ``logical_axes()`` gives the same axis tuples, so
Muon's matrix views and buckets come out as in the reference.  The
forward pass casts every master to ``param_dtypes()`` (bf16 matrices,
fp32 norms and router) on the way in, and autograd returns fp32
gradients to the masters.

  param_shapes()       name -> shape (no tensors, any size)
  logical_axes()       name -> logical-axis tuple
  param_dtypes()       name -> compute dtype of the forward pass
  cast_params()        name -> master cast to its compute dtype
  forward(batch)       -> (logits [B, S, V_padded] fp32, aux)
  loss(batch)          -> (scalar CE + aux, metrics)
  prefill(batch)       -> last position's logits [B, 1, V_padded]
  init_cache(B, len)   -> empty decode cache ({k, v, kpos}; the recurrent
                          families' below)
  prefill_cache(batch, cache_len, lengths)
                       -> (last real position's logits, filled cache)
  decode_step(cache, tokens, pos, active)
                       -> (logits [B, 1, V_padded], cache updated in place)

Families:

  dense  [attn, mlp] x L
  moe    [attn, moe_ffn] x L (``models/moe.py``); the layers' aux
         load-balancing losses add to the CE
  vlm    dense backbone over a prefix of projected patch embeddings
         (``batch["patches"]`` [B, P, vision_dim] @ ``vision_proj``),
         sliced off before the head
  audio  dense backbone over the sum of K codebook embeddings
         (``embed`` [K, V, d], tokens [B, K, S]), one head per codebook
         (``heads`` [K, d, V], logits [B, K, S, V]); the CE averages the
         codebooks
  ssm    [mamba] x L (``models/ssm.py``), attention-free: parameters
         ``layers.ln``, ``layers.mamba.*`` [L, ...]; decode cache
         {"ssm": {conv [L, B, dc - 1, di], ssm [L, B, di, ds] fp32}}
  hybrid periods of ``cfg.rglru.pattern`` (recurrent: RG-LRU + MLP,
         ``models/rglru.py``; attention: local attention over
         ``attention_window`` + MLP), parameters ``layers.p{i}.*``
         stacked [n_periods, ...], then the recurrent-only remainder
         ``tail.{i}.*`` unstacked (the reference's ``params["tail"]``
         list); decode cache {"rec": {"r{j}": {conv, h}} [n_periods, ...],
         k, v [n_periods, n_attn, B, clen, KV, Hd], kpos [B, clen],
         "tail": [{conv, h}, ...]}

``tie_embeddings`` drops ``head`` and projects onto ``embed``.  The
vocabulary pads to a multiple of 16; pad logits are masked out of the
CE.  The reference remats each block (``jax.checkpoint``).  The dense,
moe, vlm and audio families fit the sizes this port trains without it;
the recurrent families' layers run under ``torch.utils.checkpoint`` when
``cfg.remat == "block"`` (the default), since recurrentgemma-2b's 26
layers at batch 8 x seq 512 would keep ~30 GB of activations, and the
Mamba scan keeps its own per-chunk checkpoint inside, as the
reference's does.  The recurrent families prefill with one
``decode_step`` a prompt position (``_prefill_scan``), as the reference
does.  The serving methods run under ``torch.inference_mode()``;
``decode_step`` updates every cache leaf in place.

Sharded parameters (``Model.shard(mesh, shardings, strategy)``, the
layout ``launch/sharding.py::tree_shardings(param_rules(cfg, mesh,
strategy))`` gives): each rank keeps only its block of every master
(``sharding.local_block``), and every family computes on the blocks in
the Megatron / ZeRO-3 pattern.  On use, every leaf split over an axis
other than the tensor-parallel one (``embed -> data`` under "tp", the
flat ``(data, model)`` split under "zero") is all-gathered over it, one
``collectives.gather_from`` a stacked leaf and split dim a forward, whose
backward returns this rank's slice of the gradient summed over those
ranks.  Under "tp" with a model axis larger than 1 the layers run on the
rank's heads, mlp columns and vocab rows (``layers.mlp``,
``attention.attend``): the embedding masks the tokens outside the rank's
vocab rows and sums over the model axis, the head's logits are the
rank's vocab columns (``forward`` returns those), pad rows masked at the
rank's global offset, and the CE reduces the log-softmax's max (one MAX
all-reduce) and its sum of exponentials with the target logit (one SUM)
over the model axis.  Shapes come from the tensors, not from ``cfg``.
The other families on the model axis:

  moe     the layers route the global batch across the ranks holding its
          rows (``Model.rows``, set by ``shard`` and, on a data mesh with
          replicated parameters, by ``train/state.make_train_step``) and
          run the rank's experts (``layers.moe.w_up`` split over model on
          its experts dim) or every expert's columns (its expert_mlp dim)
          (``models/moe.py``);
  vlm     the dense backbone; the patches are the rank's rows and
          ``vision_proj`` is gathered on use;
  audio   each codebook's table is vocab-parallel as the dense ``embed``
          (the tokens outside the rank's rows masked, the K lookups
          summed, then one SUM over the model axis), each head gives the
          rank's vocab columns, and the CE averages the codebooks;
  ssm     each Mamba layer runs the rank's block of ``d_inner`` channels
          (``models/ssm.py``: ``in_proj`` gathered over the model axis,
          ``x_proj``'s partial sum summed forward and backward);
  hybrid  each RG-LRU layer runs the rank's block of the LRU width
          (``models/rglru.py``: the gates reduce-scattered onto it), the
          local attention the rank's heads, the MLPs their columns.

The recurrent families' remat (``_remat``) recomputes each layer in the
backward, and with it the layer's forward collectives, in the same order
on every rank.

Serving on sharded parameters (a layout under "tp" or "serve": the
latter replicates the parameters over data and gathers nothing; "zero"
is not served, as the reference serves under the first two only) keeps
the decode cache as the rank's blocks of the reference's layout,
``sharding.cache_shardings(mesh, cfg, cache, batch)``: the lanes over
the batch axes, the k/v rows and kpos over the ``kv_seq`` axes (model,
or data and model at batch 1, where every rank holds the one lane), the
kv heads whole, Mamba's ssm state and the RG-LRU's conv and h on their
channels, Mamba's conv window whole (its "model" entry falls on the
dc - 1 axis, which it does not divide).  ``serve_layout(batch,
seq_len)`` gives a ``Serving``: the block of every leaf, the rank's
lanes, the moe rows and the ``kv_seq`` place.  ``init_cache`` and
``prefill_cache`` take the global batch (``prefill_cache`` the whole
prompt batch, the same on every rank) and make their layout the model's
``serving``; ``decode_step`` takes the rank's lanes of the tokens and
positions (``sharding.decode_input_shardings``) and a cache of that
layout's blocks.  The attention layers write each new k/v row on the
rank that owns its slot and combine the softmax flash-decode style
across the ``kv_seq`` group (``attention.decode_attend``); the prefill
projects every kv head (``attend(..., whole_kv=True)``) and keeps the
rank's block of slots; the moe layers route the rank's lanes globally
over the batch group (none at batch 1); Mamba and the RG-LRU step on the
rank's channels (``ssm.mamba_decode_step``, ``rglru.rglru_decode_step``).
The serving methods return the rank's lanes' logits over the whole
padded vocab (the vocab blocks all-gathered over the model axis, kind
"logits"), so greedy argmax and sampling see every row.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import collectives
from repro_torch.config import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib

VOCAB_PAD_MULTIPLE = 16  # pad odd vocab tables so TP sharding divides
INT_SENTINEL = attn.INT32_MAX  # kpos of an empty cache slot


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def _put(specs, prefix, shapes, axes, dtypes, lead: tuple):
    """Add ``prefix + k`` -> (lead + shape, lead axes + axes, dtype) for
    every k of ``shapes``; a stacked ``lead`` takes the "layers" axis."""
    lead_axes = ("layers",) * len(lead)
    for k, shp in shapes.items():
        specs[prefix + k] = (lead + tuple(shp), lead_axes + tuple(axes[k]),
                             dtypes(k))


def _hybrid_layer_specs(specs, cfg: ModelConfig, prefix: str, lead: tuple,
                        kind: str):
    """A hybrid layer: ln1, then rglru.* (recurrent) or attn.* (attention),
    ln2, mlp.*; ``lead`` is (n_periods,) in the stacked periods, () in
    the tail."""
    if kind == "recurrent":
        mixer = ("rglru.", rglru_lib.rglru_shapes(cfg),
                 rglru_lib.rglru_axes(cfg),
                 lambda k: "float32" if k in rglru_lib.FP32 else cfg.dtype)
    else:
        mixer = ("attn.", attn.attention_shapes(cfg),
                 attn.attention_axes(cfg),
                 lambda k: "float32" if k.endswith("norm") else cfg.dtype)
    norm = (lead + (cfg.d_model,), ("layers",) * len(lead) + ("embed",),
            "float32")
    specs[prefix + "ln1"] = norm
    _put(specs, prefix + mixer[0], *mixer[1:], lead)
    specs[prefix + "ln2"] = norm
    _put(specs, prefix + "mlp.", L.mlp_shapes(cfg), L.mlp_axes(cfg),
         lambda k: cfg.dtype, lead)


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_periods, n_tail) of a hybrid config: whole periods of
    ``cfg.rglru.pattern``, then the first ``n_tail`` kinds of the pattern,
    which must be recurrent (the reference's decode path assumes it)."""
    period = len(cfg.rglru.pattern)
    n_periods = cfg.num_layers // period
    n_tail = cfg.num_layers - n_periods * period
    if not all(k == "recurrent" for k in cfg.rglru.pattern[:n_tail]):
        raise ValueError(f"a partial tail period must be recurrent-only: "
                         f"{cfg.rglru.pattern}")
    return n_periods, n_tail


def param_specs(cfg: ModelConfig) -> Dict[str, Tuple[tuple, tuple, str]]:
    """name -> (shape, logical axes, dtype name) of every parameter, in the
    order the model registers them."""
    if cfg.family not in ("dense", "moe", "vlm", "audio", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")
    V, d, Lyr = padded_vocab(cfg), cfg.d_model, cfg.num_layers
    specs = {"final_ln": ((d,), ("embed",), "float32")}
    if cfg.family == "audio":
        K = cfg.num_codebooks
        specs["embed"] = ((K, V, d), ("codebooks", "vocab", "embed"),
                          cfg.emb_dtype)
        specs["heads"] = ((K, d, V), ("codebooks", "embed", "vocab"),
                          cfg.emb_dtype)
    else:
        specs["embed"] = ((V, d), ("vocab", "embed"), cfg.emb_dtype)
        if not cfg.tie_embeddings:
            specs["head"] = ((d, V), ("embed", "vocab"), cfg.emb_dtype)
    if cfg.family == "vlm":
        specs["vision_proj"] = ((cfg.vision_dim, d), (None, "embed"),
                                cfg.emb_dtype)
    if cfg.family == "ssm":
        specs["layers.ln"] = ((Lyr, d), ("layers", "embed"), "float32")
        _put(specs, "layers.mamba.", ssm_lib.mamba_shapes(cfg),
             ssm_lib.mamba_axes(cfg),
             lambda k: "float32" if k in ssm_lib.FP32 else cfg.dtype,
             (Lyr,))
        return specs
    if cfg.family == "hybrid":
        n_periods, n_tail = hybrid_layout(cfg)
        for i, kind in enumerate(cfg.rglru.pattern):
            _hybrid_layer_specs(specs, cfg, f"layers.p{i}.", (n_periods,),
                                kind)
        for i in range(n_tail):
            _hybrid_layer_specs(specs, cfg, f"tail.{i}.", (), "recurrent")
        return specs
    specs["layers.ln1"] = ((Lyr, d), ("layers", "embed"), "float32")
    specs["layers.ln2"] = ((Lyr, d), ("layers", "embed"), "float32")
    a_shapes, a_axes = attn.attention_shapes(cfg), attn.attention_axes(cfg)
    for k, shp in a_shapes.items():
        dt = "float32" if k.endswith("norm") else cfg.dtype
        specs[f"layers.attn.{k}"] = ((Lyr,) + shp, ("layers",) + a_axes[k],
                                     dt)
    if cfg.family == "moe":
        f_shapes, f_axes, sub = (moe_lib.moe_shapes(cfg),
                                 moe_lib.moe_axes(cfg), "moe")
    else:
        f_shapes, f_axes, sub = L.mlp_shapes(cfg), L.mlp_axes(cfg), "mlp"
    for k, shp in f_shapes.items():
        dt = "float32" if k == "router" else cfg.dtype
        specs[f"layers.{sub}.{k}"] = ((Lyr,) + shp, ("layers",) + f_axes[k],
                                      dt)
    return specs


def _mlp_values(gen, cfg: ModelConfig, lead: tuple, dtype, device):
    return {k: L.dense_init(gen, lead + shp, -2, dtype, device)
            for k, shp in L.mlp_shapes(cfg).items()}


def _recurrent_values(cfg: ModelConfig, gen: torch.Generator, dt, device):
    """The ssm and hybrid layers' initial values (name -> tensor)."""
    d, vals = cfg.d_model, {}

    def put(prefix, tree):
        vals.update({prefix + k: v for k, v in tree.items()})

    if cfg.family == "ssm":
        Lyr = cfg.num_layers
        vals["layers.ln"] = torch.zeros((Lyr, d), device=device)
        put("layers.mamba.", ssm_lib.init_mamba(gen, cfg, (Lyr,), dt,
                                                device))
        return vals

    def layer(prefix, lead, kind):
        vals[prefix + "ln1"] = torch.zeros(lead + (d,), device=device)
        if kind == "recurrent":
            put(prefix + "rglru.", rglru_lib.init_rglru(gen, cfg, lead, dt,
                                                        device))
        else:  # only in the stacked periods: the tail is recurrent
            put(prefix + "attn.", attn.init_attention(gen, cfg, lead[0], dt,
                                                      device))
        vals[prefix + "ln2"] = torch.zeros(lead + (d,), device=device)
        put(prefix + "mlp.", _mlp_values(gen, cfg, lead, dt, device))

    n_periods, n_tail = hybrid_layout(cfg)
    for i, kind in enumerate(cfg.rglru.pattern):
        layer(f"layers.p{i}.", (n_periods,), kind)
    for i in range(n_tail):
        layer(f"tail.{i}.", (), "recurrent")
    return vals


def _init_values(cfg: ModelConfig, gen: torch.Generator, device):
    """Initial values in each parameter's compute dtype (as the reference's
    ``Model.init`` makes them)."""
    emb_dt, dt = torch_dtype(cfg.emb_dtype), torch_dtype(cfg.dtype)
    specs = param_specs(cfg)
    d, Lyr = cfg.d_model, cfg.num_layers
    vals = {"final_ln": torch.zeros((d,), device=device),
            "embed": L.embed_init(gen, specs["embed"][0], emb_dt, device)}
    for name in ("head", "heads", "vision_proj"):
        if name in specs:
            vals[name] = L.dense_init(gen, specs[name][0], -2, emb_dt,
                                      device)
    if cfg.family in ("ssm", "hybrid"):
        vals.update(_recurrent_values(cfg, gen, dt, device))
        return vals
    vals["layers.ln1"] = torch.zeros((Lyr, d), device=device)
    vals["layers.ln2"] = torch.zeros((Lyr, d), device=device)
    for k, v in attn.init_attention(gen, cfg, Lyr, dt, device).items():
        vals[f"layers.attn.{k}"] = v
    if cfg.family == "moe":
        for k, v in moe_lib.init_moe(gen, cfg, Lyr, dt, device).items():
            vals[f"layers.moe.{k}"] = v
    else:
        vals.update({f"layers.mlp.{k}": v for k, v in _mlp_values(
            gen, cfg, (Lyr,), dt, device).items()})
    return vals


def _sub(params, prefix: str):
    """The entries of ``params`` under ``prefix``, the prefix dropped."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _unstack(params, prefix: str):
    """The layers of the stacked entries under ``prefix``: one dict a layer
    of ``unbind`` views, whose backward stacks the layers' gradients once
    (indexing each layer would zero-fill and add a full-size gradient a
    layer)."""
    cols = {k: v.unbind(0) for k, v in _sub(params, prefix).items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _store(dst: torch.Tensor, new: torch.Tensor, active) -> None:
    """dst [B, ...] <- new in place; lanes with ``active`` False keep their
    old values bitwise (the reference's ``_gate_cache``)."""
    if active is not None:
        new = torch.where(active.reshape((-1,) + (1,) * (new.ndim - 1)),
                          new.to(dst.dtype), dst)
    dst.copy_(new)


def _store_tree(dst: Dict[str, torch.Tensor], new, active) -> None:
    for k, v in new.items():
        _store(dst[k], v, active)


def _tree_map(fn, tree):
    """``fn`` over every tensor of a decode cache tree, its nesting kept."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def cache_leaves(cache):
    """Every tensor of a decode cache (nested dicts and lists), in
    ``jax.tree``'s leaf order: dict keys sorted, list items by index."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    items = [cache[k] for k in sorted(cache)] if isinstance(cache, dict) \
        else cache
    return [t for c in items for t in cache_leaves(c)]


def _expert_split(layout) -> Optional[str]:
    """The expert dim of ``layers.moe.w_up`` [L, E, d, f] that the model
    axis splits: "experts" (expert parallelism), "expert_mlp" (each
    expert's columns), or None."""
    sh = layout.shardings.get("layers.moe.w_up")
    for d, name in ((1, "experts"), (3, "expert_mlp")):
        if "model" in sharding.split_axes(sh, d):
            return name
    return None


#: the leaves tensor parallelism runs on the model axis's blocks of (as
#: name suffixes): vocab rows and columns, heads, mlp columns, channels
_TP_LEAVES = ("embed", "head", "heads", "attn.wq", "mlp.w_up",
              "mamba.in_proj", "mamba.x_proj", "rglru.in_x", "rglru.w_a")


def _tp_leaf(name: str) -> bool:
    return name in _TP_LEAVES or name.endswith(
        tuple("." + k for k in _TP_LEAVES))


class Layout:
    """A rank's layout of a sharded ``Model``: the mesh, the strategy
    ("tp", "serve" or "zero"), each parameter's ``Sharding``, the batch
    axes the strategy splits the rows over, the tensor-parallel place
    (``tp``, None unless "tp" or "serve" with model > 1) and, for each
    parameter, the split dims gathered on use with their axes."""

    def __init__(self, mesh, shardings, strategy: str, names):
        if strategy not in ("tp", "serve", "zero"):
            raise ValueError(f"strategy {strategy!r}: 'tp', 'serve' or "
                             f"'zero'")
        self.mesh, self.strategy = mesh, strategy
        self.shardings = {k: shardings.get(k) for k in names}
        self.coords = mesh.coords()
        self.batch_axes = tuple(a for a in sharding.strategy_batch_axes(
            mesh, strategy) if mesh.shape[a] > 1)
        tp_axis = "model" if strategy in ("tp", "serve") and \
            mesh.shape.get("model", 1) > 1 else None
        self.tp = None if tp_axis is None else L.TP(
            mesh.group((tp_axis,)), mesh.shape[tp_axis],
            self.coords[tp_axis])
        self.gathered = {}
        for k, sh in self.shardings.items():
            spec = () if sh is None else sh.spec
            dims = [(d, tuple(a for a in sharding.split_axes(sh, d)
                              if a != tp_axis)) for d in range(len(spec))]
            self.gathered[k] = [(d, ax) for d, ax in dims if ax]

    @property
    def batch_size(self) -> int:
        """The ranks holding distinct rows of the batch."""
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    def gathered_axes(self, name: str):
        return tuple(a for _, ax in self.gathered[name] for a in ax)


class Serving(NamedTuple):
    """A sharded model's serving layout for one global batch and cache
    length (``Model.serve_layout``): the cache length, the
    ``cache_shardings`` of the whole cache, the rank's ``blocks`` (a
    cache tree on the meta device with each leaf's block shape), its
    ``lanes`` of the batch, the moe ``rows`` (None when no rank holds
    distinct lanes, as at batch 1) and the ``kv`` place of the slots
    (None when the cache length does not split)."""

    clen: int
    shardings: Any
    blocks: Any
    lanes: slice
    rows: Optional[moe_lib.Rows]
    kv: Optional[attn.KVSeq]


class Model(nn.Module):
    """Decoder with fp32 master parameters (see module docstring).

    ``device`` defaults to CUDA (``device.resolve_device``); ``seed``
    seeds the ``torch.Generator`` of the initial values.
    """

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.padded_vocab = padded_vocab(cfg)
        self._specs = param_specs(cfg)
        if cfg.family == "hybrid":
            self.n_periods, self.n_tail = hybrid_layout(cfg)
        self.layout: Optional[Layout] = None
        # the rank's rows of the global batch on a mesh (``Model.shard``;
        # ``train/state.make_train_step`` on a data mesh): the moe layers
        # route over them
        self.rows: Optional[moe_lib.Rows] = None
        # the serving layout of the last init_cache / prefill_cache on a
        # mesh, which decode_step serves
        self.serving: Optional[Serving] = None
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
    def reinit(self, seed: int) -> None:
        """Draw the masters anew from ``seed``, as the constructor does."""
        dev = self.embed.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.load_params(_init_values(self.cfg, gen, dev))

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy ``params`` (name -> tensor, any float dtype) into the
        masters; names and shapes must match exactly (a sharded model
        takes each leaf whole or as its own block)."""
        own = dict(self.named_parameters())
        if set(params) != set(own):
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(set(own) - set(params))}, unexpected "
                           f"{sorted(set(params) - set(own))}")
        for k, v in params.items():
            if self.layout is not None and \
                    tuple(v.shape) == tuple(self._specs[k][0]):
                v = sharding.local_block(v, self.layout.shardings[k],
                                         self.layout.coords)
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(v)

    @torch.no_grad()
    def shard(self, mesh, shardings: Dict[str, "sharding.Sharding"],
              strategy: str = "tp") -> "Model":
        """Keep only this rank's block of every master under
        ``shardings`` (name -> ``Sharding``; a missing name is
        replicated) and compute on the blocks from now on (module
        docstring); ``strategy`` is the rules' ("tp" or "zero").
        Collective: every rank of ``mesh``'s world calls it.  Returns
        the model."""
        if self.layout is not None:
            raise ValueError("the model is sharded already")
        names = [k for k, _ in self.named_parameters()]
        layout = Layout(mesh, shardings, strategy, names)
        if layout.tp is not None:
            for k in names:
                sh = layout.shardings.get(k)
                if _tp_leaf(k) and "model" not in sharding.sharded_axes(sh):
                    raise ValueError(f"tensor parallelism needs {k} split "
                                     f"over the model axis, not {sh}")
            if self.cfg.family == "moe" and _expert_split(layout) is None:
                raise ValueError(
                    f"tensor parallelism needs layers.moe.w_up split over "
                    f"the model axis on its experts or expert_mlp dim, not "
                    f"{layout.shardings.get('layers.moe.w_up')}")
        for k, p in self.named_parameters():
            p.data = sharding.local_block(p.data, layout.shardings[k],
                                          layout.coords).clone()
        self.layout = layout
        if layout.batch_size > 1:
            group = mesh.group(layout.batch_axes)
            self.rows = moe_lib.Rows(group, layout.batch_size,
                                     collectives.rank(group))
        return self

    @property
    def tp(self) -> Optional[L.TP]:
        return None if self.layout is None else self.layout.tp

    def _moe_place(self) -> Optional[moe_lib.Place]:
        """The moe layers' place on the mesh (``models/moe.py``): the
        rank's rows and model-axis place, None on one process."""
        if self.rows is None and self.tp is None:
            return None
        split = "experts" if self.tp is None else _expert_split(self.layout)
        return moe_lib.Place(self.rows, self.tp, split)

    def _use(self, params):
        """``params`` with every leaf the layout splits over a
        non-tensor-parallel axis gathered over it (FSDP / ZeRO-3)."""
        if self.layout is None:
            return params
        out = dict(params)
        mesh = self.layout.mesh
        for k, dims in self.layout.gathered.items():
            for d, axes in dims:
                out[k] = collectives.gather_from(out[k], mesh.group(axes), d)
        return out

    def _lanes(self, batch: int):
        """(the rank's lanes of a global ``batch``, the moe rows) under
        ``decode_input_shardings``, made legal for the batch as the cache
        leaves' lanes are."""
        mesh, coords = self.layout.mesh, self.layout.coords
        spec = sharding.decode_input_shardings(mesh, self.cfg,
                                               batch)["pos"].spec
        sh = sharding.named(mesh, sharding.constrain_spec(mesh, spec,
                                                          (batch, 1)))
        parts, index = sharding.block_index(sh, 0, coords)
        n = batch // parts
        axes = sharding.split_axes(sh, 0)
        rows = moe_lib.Rows(mesh.group(axes), parts, index) if axes else None
        return slice(index * n, (index + 1) * n), rows

    def serve_layout(self, batch: int, seq_len: int) -> Optional[Serving]:
        """The ``Serving`` of a global ``batch`` and a cache for
        ``seq_len`` positions on this rank (module docstring); None on one
        process.  Raises on a "zero" layout."""
        lay = self.layout
        if lay is None:
            return None
        if lay.strategy == "zero":
            raise ValueError("serving on a 'zero' layout: the reference "
                             "serves under the 'tp' and 'serve' rules only")
        mesh, cfg = lay.mesh, self.cfg
        whole = self._empty_cache(batch, seq_len, torch.device("meta"))
        shs = sharding.cache_shardings(mesh, cfg, whole, batch)
        if cfg.family == "ssm" and "model" in sharding.sharded_axes(
                shs["ssm"]["conv"]):
            raise ValueError(f"Mamba's conv window split over the model "
                             f"axis ({shs['ssm']['conv'].spec}): a model "
                             f"axis that divides conv_dim - 1 is not served")
        kv = None
        if "kpos" in shs:
            axes = sharding.split_axes(shs["kpos"], 1)
            if axes:
                kv = attn.KVSeq(mesh.group(axes), *sharding.block_index(
                    shs["kpos"], 1, lay.coords))
        lanes, rows = self._lanes(batch)
        return Serving(self.cache_len(seq_len), shs,
                       sharding.cache_blocks(mesh, cfg, whole, batch,
                                             lay.coords), lanes, rows, kv)

    @contextlib.contextmanager
    def _routing(self, rows: Optional[moe_lib.Rows]):
        """On a mesh the moe layers route over the serving lanes' ``rows``
        inside (None: every rank holds the same lanes)."""
        if self.layout is None:
            yield
            return
        saved, self.rows = self.rows, rows
        try:
            yield
        finally:
            self.rows = saved

    def _serving_of(self, cache) -> Optional[Serving]:
        """The layout ``decode_step`` serves ``cache`` under: the model's
        ``serving``, whose blocks the cache's leaves must match."""
        if self.layout is None:
            return None
        srv = self.serving
        if srv is None or [tuple(t.shape) for t in cache_leaves(cache)] != \
                [tuple(t.shape) for t in cache_leaves(srv.blocks)]:
            raise ValueError("decode_step on a mesh serves a cache of the "
                             "blocks of the last init_cache / prefill_cache")
        return srv

    def whole_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's lanes of ``x`` (its lanes on dim 0) in lane order,
        all-gathered over the serving batch group (collective); ``x`` on
        one process or when no rank holds distinct lanes."""
        srv = self.serving
        if self.layout is None or srv is None or srv.rows is None:
            return x
        return collectives.all_gather(x, srv.rows.group, kind="lanes")

    def _vocab_offset(self, rows: int) -> int:
        """The first global vocab row of this rank's ``rows`` rows."""
        return 0 if self.tp is None else self.tp.index * rows

    # ------------------------------------------------------------- pieces

    def _embed_tokens(self, params, tokens):
        cfg = self.cfg
        emb = params["embed"]
        # audio tokens [B, K, S]: one table a codebook, the lookups summed
        book = (torch.arange(cfg.num_codebooks, device=tokens.device)
                [None, :, None],) if cfg.family == "audio" else ()
        if self.tp is None:
            x = emb[book + (tokens,)]
        else:
            # vocab-parallel: this rank's rows, zeros elsewhere, summed
            rows = emb.shape[-2]
            local = tokens - self._vocab_offset(rows)
            mine = (local >= 0) & (local < rows)
            x = emb[book + (torch.where(mine, local, 0),)]
            x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
        if cfg.family == "audio":
            x = torch.sum(x, dim=1)
        if self.tp is not None:
            x = collectives.reduce_from(x, self.tp.group)
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return x.to(torch_dtype(cfg.dtype))

    def _lm_logits(self, params, x):
        cfg = self.cfg
        x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
        if self.tp is not None:
            x = collectives.copy_to(x, self.tp.group)
        if cfg.family == "audio":
            logits = torch.einsum("bsd,kdv->bksv", x, params["heads"])
        elif cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
        else:
            logits = x @ params["head"]
        logits = L.softcap(logits.float(), cfg.logits_softcap)
        if self.padded_vocab != cfg.vocab_size:  # mask pad rows out of CE
            rows = logits.shape[-1]
            iota = self._vocab_offset(rows) + torch.arange(
                rows, device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits,
                                 torch.full((), L.NEG_INF,
                                            device=logits.device))
        return logits

    def _layers(self, params):
        """Per-layer (attention, feed-forward, ln1, ln2) parameter dicts;
        the feed-forward is the moe subtree or the mlp."""
        lay = {k[len("layers."):]: v for k, v in params.items()
               if k.startswith("layers.")}
        sub = "moe." if self.cfg.family == "moe" else "mlp."
        for i in range(self.cfg.num_layers):
            p = {k: v[i] for k, v in lay.items()}
            a = {k[len("attn."):]: v for k, v in p.items()
                 if k.startswith("attn.")}
            m = {k[len(sub):]: v for k, v in p.items() if k.startswith(sub)}
            yield a, m, p["ln1"], p["ln2"]

    def _ffn(self, m, x):
        """The layer's feed-forward -> (out, aux loss)."""
        if self.cfg.family == "moe":
            return moe_lib.moe_ffn(m, x, self.cfg, self._moe_place())
        return L.mlp(m, x, self.cfg, self.tp), 0.0

    def _block(self, layer, x, positions, whole_kv: bool = False):
        """One decoder layer -> (x, aux, (k, v)): the (k, v) ``attend``
        projects (every kv head with ``whole_kv``), which the serving
        prefill stacks into its cache."""
        cfg = self.cfg
        a, m, ln1, ln2 = layer
        h, kv = attn.attend(a, L.rms_norm(x, ln1, cfg.norm_eps), positions,
                            cfg, tp=self.tp, whole_kv=whole_kv)
        x = x + h
        h, aux = self._ffn(m, L.rms_norm(x, ln2, cfg.norm_eps))
        return x + h, aux, kv

    def _rec_layer(self, p, x):
        """A hybrid recurrent layer (RG-LRU, then the MLP)."""
        cfg = self.cfg
        x = x + rglru_lib.rglru_block(
            _sub(p, "rglru."), L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
            self.tp)
        return x + L.mlp(_sub(p, "mlp."), L.rms_norm(x, p["ln2"],
                                                     cfg.norm_eps), cfg,
                         self.tp)

    def _attn_layer(self, p, x, positions):
        """A hybrid attention layer (local window, then the MLP)."""
        cfg = self.cfg
        h, _ = attn.attend(_sub(p, "attn."),
                           L.rms_norm(x, p["ln1"], cfg.norm_eps), positions,
                           cfg, window=cfg.rglru.attention_window, tp=self.tp)
        x = x + h
        return x + L.mlp(_sub(p, "mlp."), L.rms_norm(x, p["ln2"],
                                                     cfg.norm_eps), cfg,
                         self.tp)

    def _mamba_layer(self, p, x):
        cfg = self.cfg
        return x + ssm_lib.mamba_block(
            _sub(p, "mamba."), L.rms_norm(x, p["ln"], cfg.norm_eps), cfg,
            tp=self.tp)

    def _remat(self, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint`` when the config
        remats each block and autograd records (backward keeps the layer's
        input and recomputes the rest)."""
        if self.cfg.remat == "block" and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _recurrent_backbone(self, params, x, positions):
        """The ssm stack, or the hybrid periods and then the tail; each
        layer rematerialized as the reference's ``jax.checkpoint(body)``
        (``cfg.remat``)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            for p in _unstack(params, "layers."):
                x = self._remat(self._mamba_layer, p, x)
            return x
        pattern = cfg.rglru.pattern
        periods = zip(*(_unstack(params, f"layers.p{i}.")
                        for i in range(len(pattern))))
        for period in periods:
            for kind, p in zip(pattern, period):
                x = self._remat(self._rec_layer, p, x) \
                    if kind == "recurrent" \
                    else self._remat(self._attn_layer, p, x, positions)
        for i in range(self.n_tail):
            x = self._remat(self._rec_layer, _sub(params, f"tail.{i}."), x)
        return x

    def _backbone(self, params, x, positions):
        """x [B, S, D] -> (x, summed aux loss); one loop over the stacked
        layers."""
        if self.cfg.family in ("ssm", "hybrid"):
            return self._recurrent_backbone(params, x, positions), 0.0
        total = 0.0
        for layer in self._layers(params):
            x, aux, _ = self._block(layer, x, positions)
            total = total + aux
        return x, total

    def _backbone_kv(self, params, x, positions):
        """The backbone that also returns each layer's projected k and v,
        stacked [L, B, S, KV, Hd] (every kv head), for the serving
        prefill."""
        ks, vs = [], []
        for layer in self._layers(params):
            x, _, (k, v) = self._block(layer, x, positions, whole_kv=True)
            ks.append(k)
            vs.append(v)
        return x, torch.stack(ks), torch.stack(vs)

    def _inputs(self, params, batch):
        """Embedded tokens, behind the projected patch prefix for vlm ->
        (x [B, P + S, D], P)."""
        x = self._embed_tokens(params, batch["tokens"])
        if self.cfg.family != "vlm":
            return x, 0
        px = batch["patches"].to(x.dtype) @ params["vision_proj"]
        return torch.cat([px.to(x.dtype), x], dim=1), px.shape[1]

    def _positions(self, x):
        B, S = x.shape[0], x.shape[1]
        return torch.arange(S, dtype=torch.int32,
                            device=x.device).expand(B, S)

    # ------------------------------------------------------------- public

    def forward(self, batch, params: Optional[Dict] = None):
        """Full-sequence fp32 logits over the padded vocab (a rank's vocab
        columns under tensor parallelism), and aux."""
        params = self._use(self.cast_params() if params is None else params)
        x, P = self._inputs(params, batch)
        x, aux = self._backbone(params, x, self._positions(x))
        return self._lm_logits(params, x[:, P:]), aux

    def loss(self, batch, params: Optional[Dict] = None,
             chunk: Optional[int] = None):
        """Next-token CE with seq-chunked logits, plus the MoE aux loss ->
        (loss, metrics)."""
        params = self._use(self.cast_params() if params is None else params)
        x, P = self._inputs(params, batch)
        x, aux = self._backbone(params, x, self._positions(x))
        ce = self._ce_from_hidden(params, x[:, P:], batch["tokens"], chunk)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux,
                      "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}

    def _ce_from_hidden(self, params, x, tokens,
                        chunk: Optional[int] = None):
        """Chunked next-token CE given backbone output x [B, S, D]: the LM
        head runs per sequence chunk, so at most [B, (K,) chunk, V] logits
        exist at once.  Audio targets are [B, K, S]; its CE averages the
        codebooks."""
        chunk = chunk or self.cfg.loss_chunk
        audio = self.cfg.family == "audio"
        B = x.shape[0]
        tg = tokens[..., 1:]
        xs = x[:, :-1]
        Sm1 = xs.shape[1]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for s0 in range(0, Sm1, chunk):
            logits = self._lm_logits(params, xs[:, s0:s0 + chunk])
            if self.tp is not None:
                nll = self._tp_nll(logits, tg[..., s0:s0 + chunk])
            else:
                logp = torch.log_softmax(logits, dim=-1)
                nll = -torch.gather(
                    logp, -1, tg[..., s0:s0 + chunk, None].long())[..., 0]
            if audio:
                nll = torch.mean(nll, dim=1)  # average codebooks
            total = total + torch.sum(nll)
        return total / (B * Sm1)

    def _tp_nll(self, logits, targets):
        """-log softmax at ``targets`` from this rank's vocab columns of
        the logits: the max, the sum of exponentials and the target logit
        each reduced over the model axis."""
        group = self.tp.group
        m = collectives.all_reduce(torch.amax(logits.detach(), dim=-1),
                                   "max", group, kind="tp")
        sumexp = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        local = targets.long() - self._vocab_offset(logits.shape[-1])
        mine = (local >= 0) & (local < logits.shape[-1])
        picked = torch.gather(logits, -1,
                              torch.where(mine, local, 0)[..., None])[..., 0]
        target = torch.where(mine, picked,
                             torch.zeros((), device=logits.device))
        sumexp, target = collectives.reduce_from(
            torch.stack([sumexp, target]), group)
        return torch.log(sumexp) + m - target

    # ------------------------------------------------------------- decode

    def cache_len(self, seq_len: int) -> int:
        """Decode-cache length a sequence of ``seq_len`` needs (a rolling
        buffer of the window for sliding-window and the hybrid's local
        attention; none for ssm)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return 0
        if cfg.sliding_window:
            return min(seq_len, cfg.sliding_window)
        if cfg.family == "hybrid":
            return min(seq_len, cfg.rglru.attention_window)
        return seq_len

    def _serve_params(self, params):
        """The parameters in use for a serving call: ``_use``'s, and under
        tensor parallelism Mamba's ``in_proj`` gathered whole over the
        model axis once for the call (``ssm.mamba_decode_step``; the scan
        prefill's every step takes it)."""
        params = self._use(params)
        if self.cfg.family == "ssm" and self.tp is not None:
            params = dict(params)
            params["layers.mamba.in_proj"] = collectives.gather_from(
                params["layers.mamba.in_proj"], self.tp.group, -1,
                "tp_gather")
        return params

    def _serve_logits(self, params, x):
        """``_lm_logits`` over the whole padded vocab: under tensor
        parallelism the ranks' vocab blocks all-gathered over the model
        axis."""
        logits = self._lm_logits(params, x)
        if self.tp is None:
            return logits
        return collectives.all_gather(logits, self.tp.group, dim=-1,
                                      kind="logits")

    @torch.inference_mode()
    def prefill(self, batch, params: Optional[Dict] = None):
        """Serving prefill: the backbone over the whole prompt, fp32
        logits [B, 1, V_padded] of the last position only (on a mesh the
        rank's lanes of the whole prompt batch)."""
        params = self._use(self.cast_params() if params is None else params)
        rows = None
        if self.layout is not None:
            lanes, rows = self._lanes(batch["tokens"].shape[0])
            batch = {k: v[lanes] for k, v in batch.items()}
        with self._routing(rows):
            x, _ = self._inputs(params, batch)
            x, _ = self._backbone(params, x, self._positions(x))
        return self._serve_logits(params, x[:, -1:])

    def _empty_cache(self, batch: int, seq_len: int, dev):
        """The whole empty decode cache on ``dev`` (``init_cache``)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        if cfg.family == "ssm":
            return {"ssm": ssm_lib.init_mamba_cache(
                cfg, batch, dt, (cfg.num_layers,), dev)}
        clen = self.cache_len(seq_len)
        kv_shape = (batch, clen, attn.padded_heads(cfg)[1],
                    cfg.resolved_head_dim)
        kpos = torch.full((batch, clen), INT_SENTINEL, dtype=torch.int32,
                          device=dev)
        if cfg.family == "hybrid":
            n_attn = sum(k == "attention" for k in cfg.rglru.pattern)
            n_rec = len(cfg.rglru.pattern) - n_attn
            shape = (self.n_periods, n_attn) + kv_shape
            cache = {
                "rec": {f"r{i}": rglru_lib.init_rglru_cache(
                    cfg, batch, dt, (self.n_periods,), dev)
                    for i in range(n_rec)},
                "k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "kpos": kpos}
            if self.n_tail:
                cache["tail"] = [rglru_lib.init_rglru_cache(
                    cfg, batch, dt, (), dev) for _ in range(self.n_tail)]
            return cache
        shape = (cfg.num_layers,) + kv_shape
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "kpos": kpos}

    @torch.inference_mode()
    def init_cache(self, batch: int, seq_len: int):
        """An empty decode cache for ``batch`` lanes: k/v zeros [L, B,
        clen, KV, Hd] in the compute dtype, kpos [B, clen] int32 at
        ``INT_SENTINEL`` (clen = ``cache_len(seq_len)``); the recurrent
        families' layouts are in the module docstring (conv states in the
        compute dtype, the ssm and RG-LRU states fp32, zeros).  On a mesh
        ``batch`` is the global batch and the cache this rank's blocks of
        ``serve_layout(batch, seq_len)``, which becomes the model's
        ``serving``."""
        srv = self.serve_layout(batch, seq_len)
        if srv is None:
            return self._empty_cache(batch, seq_len, self.embed.device)
        return self._empty_blocks(srv)

    def _empty_blocks(self, srv: Serving):
        """The rank's blocks of an empty cache under ``srv``, which
        becomes the model's ``serving``."""
        self.serving = srv
        dev = self.embed.device
        # kpos is the cache's one integer leaf
        return _tree_map(lambda t: torch.full(
            t.shape, INT_SENTINEL if t.dtype == torch.int32 else 0,
            dtype=t.dtype, device=dev), srv.blocks)

    @torch.inference_mode()
    def prefill_cache(self, batch, cache_len: int, lengths=None,
                      params: Optional[Dict] = None):
        """One-pass serving prefill of a right-padded prompt batch ->
        (logits [B, 1, V_padded] at each lane's last real position, a cache
        shaped as ``init_cache(B, cache_len)`` ready for ``decode_step`` at
        pos = length).

        ``lengths`` [B] gives each lane's real prompt length (None: every
        token is real).  Slot s of lane b holds that lane's newest real
        position p = s (mod clen), as a streamed decode loop (writing at
        pos % clen) would have left it; pad positions never enter the
        cache (kpos stays the sentinel, k/v zeros).  It matches a streamed
        decode loop when the rolling cache drops no position still inside
        the attention window (``cache_len`` >= the prompt for full
        attention).  A vlm prompt's positions and cache include its patch
        prefix, and it takes no ``lengths``.  The recurrent families run
        ``_prefill_scan``.  On a mesh every rank passes the whole prompt
        batch and ``lengths``, and gets its lanes' logits and its blocks
        of the cache (module docstring)."""
        cfg = self.cfg
        params = self._serve_params(self.cast_params() if params is None
                                    else params)
        B = batch["tokens"].shape[0]
        srv = self.serve_layout(B, cache_len)
        if srv is not None:
            self.serving = srv
            batch = {k: v[srv.lanes] for k, v in batch.items()}
            if lengths is not None:
                lengths = torch.as_tensor(lengths)[srv.lanes]
        with self._routing(None if srv is None else srv.rows):
            if cfg.family in ("ssm", "hybrid"):
                cache = self._empty_cache(B, cache_len, self.embed.device) \
                    if srv is None else self._empty_blocks(srv)
                return self._prefill_scan(batch, cache, lengths, params, srv)
            return self._prefill_kv(batch, cache_len, lengths, params, srv)

    def _prefill_kv(self, batch, cache_len: int, lengths, params, srv):
        """``prefill_cache`` of the attention families on the rank's
        lanes: the k/v rows and kpos of its block of the slots."""
        cfg = self.cfg
        if cfg.family == "vlm":
            assert lengths is None, \
                "ragged prompts are not supported for vlm prefill"
        x, _ = self._inputs(params, batch)
        B, S = x.shape[0], x.shape[1]
        x, ks, vs = self._backbone_kv(params, x, self._positions(x))

        clen = self.cache_len(cache_len)
        kv = None if srv is None else srv.kv
        n = clen if kv is None else clen // kv.size
        s0 = 0 if kv is None else kv.index * n
        dev = x.device
        L_real = torch.full((B,), S, dtype=torch.int32, device=dev) \
            if lengths is None else torch.as_tensor(
                lengths, device=dev).to(torch.int32)
        s_idx = torch.arange(s0, s0 + n, dtype=torch.int32, device=dev)
        q = torch.div(L_real[:, None] - 1 - s_idx[None, :], clen,
                      rounding_mode="floor")  # [B, n]
        win = s_idx[None, :] + clen * q
        has = win >= 0
        # clipped before the gather, as the reference does: a negative
        # index must not wrap
        src = torch.clamp(win, 0, S - 1).long()
        idx = src[None, :, :, None, None].expand(
            (ks.shape[0], B, n) + ks.shape[3:])
        mask5 = has[None, :, :, None, None]
        dt = torch_dtype(cfg.dtype)
        new_k = torch.where(mask5, torch.gather(ks, 2, idx), 0).to(dt)
        new_v = torch.where(mask5, torch.gather(vs, 2, idx), 0).to(dt)
        kpos = torch.where(has, win, INT_SENTINEL)

        if lengths is None:
            x_last = x[:, -1:]
        else:
            at = (L_real - 1).long().reshape(B, 1, 1).expand(
                B, 1, x.shape[-1])
            x_last = torch.gather(x, 1, at)
        return self._serve_logits(params, x_last), \
            {"k": new_k, "v": new_v, "kpos": kpos}

    def _prefill_scan(self, batch, cache, lengths, params, srv):
        """The recurrent families' prefill: one decode step a prompt
        position from the empty ``cache``, lanes past their ``lengths``
        inactive (their state frozen bitwise), each lane's logits taken
        at its last real position; bitwise the streamed decode loop it
        replaces."""
        tokens = batch["tokens"]
        B, S = tokens.shape[0], tokens.shape[-1]
        dev = tokens.device
        L_real = None if lengths is None else torch.as_tensor(
            lengths, device=dev).to(torch.int32)
        last = torch.zeros((B, 1, self.padded_vocab), dtype=torch.float32,
                           device=dev)
        for t in range(S):
            pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
            act = None if L_real is None else t < L_real
            logits, cache = self._decode(cache, tokens[..., t:t + 1], pos,
                                         act, params, srv)
            if L_real is None:
                last = logits if t == S - 1 else last
            else:
                last = torch.where((t == L_real - 1).reshape(B, 1, 1),
                                   logits, last)
        return last, cache

    def _decode_ssm(self, params, cache, x, active):
        cfg = self.cfg
        c = cache["ssm"]
        for i, p in enumerate(_unstack(params, "layers.")):
            ci = {k: v[i] for k, v in c.items()}
            y, new = ssm_lib.mamba_decode_step(
                _sub(p, "mamba."), L.rms_norm(x, p["ln"], cfg.norm_eps), ci,
                cfg, tp=self.tp)
            _store_tree(ci, new, active)
            x = x + y
        return x

    def _rec_decode(self, p, x, c, active):
        """One hybrid recurrent layer's decode step; its cache ``c``
        ({conv, h} [B, ...]) updated in place."""
        cfg = self.cfg
        y, new = rglru_lib.rglru_decode_step(
            _sub(p, "rglru."), L.rms_norm(x, p["ln1"], cfg.norm_eps), c, cfg,
            self.tp)
        _store_tree(c, new, active)
        x = x + y
        return x + L.mlp(_sub(p, "mlp."), L.rms_norm(x, p["ln2"],
                                                     cfg.norm_eps), cfg,
                         self.tp)

    def _decode_hybrid(self, params, cache, x, pos, active, srv):
        cfg = self.cfg
        clen = cache["k"].shape[3] if srv is None else srv.clen
        kv = None if srv is None else srv.kv
        slot = (pos[:, 0] % clen).long()
        # kpos first: every attention layer attends over it
        attn.write_rows(cache["kpos"], slot, pos.to(torch.int32), active, kv)
        pattern = cfg.rglru.pattern
        periods = zip(*(_unstack(params, f"layers.p{i}.")
                        for i in range(len(pattern))))
        for j, period in enumerate(periods):
            ai = ri = 0
            for kind, p in zip(pattern, period):
                if kind == "recurrent":
                    c = {k: v[j] for k, v in cache["rec"][f"r{ri}"].items()}
                    x = self._rec_decode(p, x, c, active)
                    ri += 1
                    continue
                y, _, _ = attn.decode_attend(
                    _sub(p, "attn."), L.rms_norm(x, p["ln1"], cfg.norm_eps),
                    pos, cache["k"][j, ai], cache["v"][j, ai],
                    cache["kpos"], slot, cfg,
                    window=cfg.rglru.attention_window, active=active,
                    tp=self.tp, kv=kv)
                ai += 1
                x = x + y
                x = x + L.mlp(_sub(p, "mlp."),
                              L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                              self.tp)
        for i in range(self.n_tail):
            x = self._rec_decode(_sub(params, f"tail.{i}."), x,
                                 cache["tail"][i], active)
        return x

    @torch.inference_mode()
    def decode_step(self, cache, tokens, pos, active=None,
                    params: Optional[Dict] = None):
        """tokens [B, 1] ([B, K, 1] audio); pos [B, 1] absolute positions
        -> (fp32 logits [B, 1, V_padded] ([B, K, 1, V_padded] audio) of
        the new token, ``cache``).

        The cache is updated in place: each lane writes its new k/v rows
        and kpos at slot pos % clen (a rolling buffer).  ``active`` [B]
        bool is the serving slot mask: lanes with False leave every cache
        leaf bitwise unchanged; their logits are garbage the caller masks.
        None means every lane is live.  A moe layer routes the B lanes as
        one global dispatch (``models/moe.py``), inactive lanes too, as
        the reference does.  The recurrent families write their conv and
        recurrent states in place the same way (the hybrid's attention
        layers its rolling k/v rows).  On a mesh ``tokens``, ``pos`` and
        ``active`` are the rank's lanes and ``cache`` its blocks of the
        model's ``serving`` layout (module docstring)."""
        params = self._serve_params(self.cast_params() if params is None
                                    else params)
        srv = self._serving_of(cache)
        with self._routing(None if srv is None else srv.rows):
            return self._decode(cache, tokens, pos, active, params, srv)

    def _decode(self, cache, tokens, pos, active, params, srv):
        """``decode_step`` on the parameters in use and the layout
        ``srv`` (None on one process)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        if cfg.family == "ssm":
            return self._serve_logits(params, self._decode_ssm(
                params, cache, x, active)), cache
        if cfg.family == "hybrid":
            return self._serve_logits(params, self._decode_hybrid(
                params, cache, x, pos, active, srv)), cache
        clen = cache["k"].shape[2] if srv is None else srv.clen
        kv = None if srv is None else srv.kv
        slot = (pos[:, 0] % clen).long()  # [B]
        # kpos first: every layer attends over the updated positions
        attn.write_rows(cache["kpos"], slot, pos.to(torch.int32), active, kv)
        for i, (a, m, ln1, ln2) in enumerate(self._layers(params)):
            y, _, _ = attn.decode_attend(
                a, L.rms_norm(x, ln1, cfg.norm_eps), pos, cache["k"][i],
                cache["v"][i], cache["kpos"], slot, cfg, active=active,
                tp=self.tp, kv=kv)
            x = x + y
            x = x + self._ffn(m, L.rms_norm(x, ln2, cfg.norm_eps))[0]
        return self._serve_logits(params, x), cache
