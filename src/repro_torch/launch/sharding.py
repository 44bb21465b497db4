"""Logical-axis -> mesh-axis sharding rules (counterpart of
``repro/launch/sharding.py``), as pure functions of a mesh's shape.

Every parameter, state, cache and input dimension carries a logical name
(the models' ``logical_axes``); these rules map the names to mesh axes:

  embed      -> data            (FSDP / ZeRO-3: params gathered on use)
  vocab/mlp/heads/expert_mlp -> model   (tensor parallelism)
  experts    -> model for EP archs (num_experts % model == 0), else None
  batch      -> (pod, data)     (data parallelism; pod axis is pure DP)
  kv_seq     -> model           (decode KV caches; (data, model) when the
                                 batch is 1)
  layers / head_dim / codebooks -> never sharded

A spec is a tuple with one entry a tensor dimension: None, a mesh axis
name, or a tuple of axis names, in the form of the reference's
``PartitionSpec``; a ``Sharding`` pairs it with its mesh as the
reference's ``NamedSharding`` does, and ``placements`` turns it into
DTensor placements for the mesh's ``DeviceMesh``.  The rules take any
mesh with ``shape``/``axis_names`` (``launch/mesh.py``), the production
meshes included.

The layout arithmetic lives here too: ``local_shape``/``local_block``
give a rank's block of a leaf (numpy or torch; mesh axes of size 1 split
nothing, a dim split over several axes takes them in mesh order, row
major), ``full_shape`` inverts ``local_shape``, and ``gather_full``
all-gathers a block back to the whole leaf over the axes it is split on,
dim by dim.  ``cache_blocks``/``gather_cache`` do the same for every
leaf of a decode cache tree under ``cache_shardings``.  The model, the
optimizer and the checkpoints take their blocks through these functions
only.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

from repro_torch.config import ModelConfig

Spec = Tuple[Any, ...]


class Sharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``); ``named``
    makes one and checks it."""

    mesh: Any
    spec: Spec


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis, or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def named(mesh, spec: Spec) -> Sharding:
    """``Sharding(mesh, spec)`` in ``PartitionSpec``'s normal form (a
    one-axis tuple is its axis, an empty one None); raises, as
    ``NamedSharding`` does, when a mesh axis splits more than one
    dimension."""
    spec = tuple(None if e is None or not axes_of(e) else
                 (axes_of(e)[0] if len(axes_of(e)) == 1 else axes_of(e))
                 for e in spec)
    used = [a for e in spec for a in axes_of(e)]
    dup = sorted({a for a in used if used.count(a) > 1})
    if dup:
        raise ValueError(f"spec {spec} maps mesh axes {dup} to more than "
                         f"one dimension")
    return Sharding(mesh, spec)


def placements(sharding: Sharding):
    """DTensor placements of ``sharding``, one a mesh axis: ``Shard(d)``
    for the axis that splits tensor dim ``d``, ``Replicate()`` else."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for ax in sharding.mesh.axis_names:
        dims = [d for d, e in enumerate(sharding.spec) if ax in axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_rules(cfg: ModelConfig, mesh, strategy: str = "tp"
                ) -> Dict[Any, Any]:
    """Parameter sharding rules.

    strategy="tp"   (baseline): FSDP over data x tensor-parallel over model.
    strategy="zero" pure ZeRO-3: params flat-sharded over every mesh axis,
                    batch over the whole mesh, no TP activation
                    all-reduces (expert weights keep their 2D EP/TP
                    sharding).
    strategy="serve" decode: params replicated over data, sharded over
                    model only.
    """
    expert_ep = (cfg.moe is not None and cfg.moe.sharding == "expert")
    if strategy == "serve":
        base = param_rules(cfg, mesh, "tp")
        base["embed"] = None
        return base
    if strategy == "zero":
        flat = tuple(mesh.axis_names)
        return {
            "embed": flat,
            "vocab": None,
            "mlp": None,
            "expert_mlp": None if expert_ep else "model",
            "experts": "model" if expert_ep else None,
            "heads": None,
            "kv_heads": None,
            "head_dim": None,
            "layers": None,
            "codebooks": None,
            None: None,
        }
    model_ax = "model"
    return {
        "embed": "data",
        "vocab": model_ax,
        "mlp": model_ax,
        "expert_mlp": None if expert_ep else model_ax,
        "experts": model_ax if expert_ep else None,
        "heads": model_ax,
        "kv_heads": None,   # kv heads < model axis on every GQA arch
        "head_dim": None,
        "layers": None,
        "codebooks": None,
        None: None,
    }


def spec_from_axes(axes: Tuple, rules: Dict[Any, Any]) -> Spec:
    return tuple(rules.get(a, None) for a in axes)


def _axis_size(mesh, entry) -> int:
    n = 1
    for e in axes_of(entry):
        n *= mesh.shape[e]
    return n


def constrain_spec(mesh, spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """A spec legal for ``shape``: mesh axes are dropped from dims they do
    not divide, and an axis used by more than one dim keeps only its
    later (more specific) use."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used: set = set()
    for i in range(len(entries) - 1, -1, -1):
        e = entries[i]
        if e is None:
            continue
        kept = [a for a in axes_of(e) if a not in used]
        used.update(kept)
        entries[i] = tuple(kept) if len(kept) > 1 else \
            (kept[0] if kept else None)
    out = []
    for dim, entry in zip(shape, entries):
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return tuple(out)


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and \
        all(isinstance(x, (str, type(None))) for x in t)


def _shape_of(s) -> Tuple[int, ...]:
    """The shape of a tensor, an array or a shape tuple; () for a number."""
    if hasattr(s, "shape"):
        s = s.shape
    elif not isinstance(s, (tuple, list)):
        return ()
    return tuple(int(d) for d in s)


def tree_shardings(mesh, axes_tree, rules, shapes_tree=None) -> Any:
    """A tree of ``Sharding``s shaped like ``axes_tree`` (nested dicts
    and lists whose leaves are logical-axis tuples); with
    ``shapes_tree`` (the same nesting; shapes, or tensors) each spec is
    made legal for its leaf's shape."""
    if _is_axes(axes_tree):
        spec = spec_from_axes(axes_tree, rules)
        if shapes_tree is not None:
            spec = constrain_spec(mesh, spec, _shape_of(shapes_tree))
        return named(mesh, spec)
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(mesh, v, rules, None if shapes_tree is None
                                  else shapes_tree[k])
                for k, v in axes_tree.items()}
    return [tree_shardings(mesh, v, rules, None if shapes_tree is None
                           else shapes_tree[i])
            for i, v in enumerate(axes_tree)]


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def strategy_batch_axes(mesh, strategy: str = "tp") -> Tuple[str, ...]:
    """The axes a strategy's ``batch`` rule splits the rows over: the
    whole mesh under "zero", (pod, data) otherwise."""
    return tuple(mesh.axis_names) if strategy == "zero" else batch_axes(mesh)


def activation_rules(cfg: ModelConfig, mesh, strategy: str = "tp"
                     ) -> Dict[str, Any]:
    """Logical-axis rules for activations, installed with
    ``sharding_ctx.activation_sharding``."""
    expert_ep = (cfg.moe is not None and cfg.moe.sharding == "expert")
    if strategy == "serve":
        return activation_rules(cfg, mesh, "tp")
    if strategy == "zero":
        flat = tuple(mesh.axis_names)
        return {
            "batch": flat, "seq": None, "embed": None, "embed_act": None,
            "heads": None, "kv_heads": None, "head_dim": None, "mlp": None,
            "expert_mlp": None if expert_ep else "model",
            "experts": "model" if expert_ep else None, "vocab": None,
            "kv_seq": "model",
            "opt_layers": "model", "opt_rows": "data", "opt_basis": None,
        }
    return {
        "batch": batch_axes(mesh),
        "seq": None,
        "embed": None,
        "embed_act": None,
        "heads": "model",
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "expert_mlp": None if expert_ep else "model",
        "experts": "model" if expert_ep else None,
        "vocab": "model",
        "kv_seq": "model",
        "opt_layers": "model", "opt_rows": "data", "opt_basis": None,
    }


def pipeline_rules(rules: Dict[str, Any]) -> Dict[str, Any]:
    """Rules for 1F1B pipelining over "pod": ``layers`` over pod, ``batch``
    without pod, and ``opt_batch`` pinning the §8 engine's batch
    partitioning to ("data",) (``bucketing.mesh_batch_axes``)."""
    out = dict(rules)
    if "layers" in out:
        out["layers"] = "pod"
    if "batch" in out:
        b = tuple(a for a in axes_of(out["batch"]) if a != "pod")
        out["batch"] = b if b else None
    out["opt_batch"] = ("data",)
    return out


def train_batch_shardings(mesh, cfg: ModelConfig, pipeline: bool = False):
    b = ("data",) if pipeline else batch_axes(mesh)
    out = {"tokens": named(mesh, (b, None, None))
           if cfg.family == "audio" else named(mesh, (b, None))}
    if cfg.family == "vlm":
        out["patches"] = named(mesh, (b, None, None))
    return out


def cache_shardings(mesh, cfg: ModelConfig, cache, batch_size: int):
    """Shardings of a decode cache tree (``Model.init_cache``), by each
    leaf's role (its path's names) and rank."""
    b = batch_axes(mesh)
    kv_seq = ("data", "model") if batch_size == 1 else "model"
    bax = None if batch_size == 1 else b

    def one(names, leaf):
        ndim = len(_shape_of(leaf))
        if "kpos" in names:
            spec = (bax, kv_seq)
        elif "k" in names or "v" in names:
            spec = (None,) * (ndim - 4) + (bax, kv_seq, None, None)
        elif "ssm" in names and ndim == 4:  # [L, B, d_inner, state]
            spec = (None, bax, "model", None)
        elif "conv" in names:  # [L?, B, dc-1, d_inner]
            spec = (None,) * (ndim - 3) + (bax, None, "model")
        elif "h" in names:  # rglru state [P?, B, width]
            spec = (None,) * (ndim - 2) + (bax, "model")
        else:
            spec = (None,) * ndim
        return named(mesh, constrain_spec(mesh, spec, _shape_of(leaf)))

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, names + ("",)) for v in node]
        return one(names, node)

    return walk(cache, ())


def decode_input_shardings(mesh, cfg: ModelConfig, batch_size: int):
    b = None if batch_size == 1 else batch_axes(mesh)
    tok = named(mesh, (b, None, None)) if cfg.family == "audio" \
        else named(mesh, (b, None))
    return {"tokens": tok, "pos": named(mesh, (b, None))}


#: optimizer-state keys that hold cached preconditioner buffers with a
#: layout other than the parameter's: the active caches and their §12
#: pending twins, which shard as their active halves do
PRECOND_CACHE_STATE_KEYS = frozenset({
    "ortho", "Linv", "Rinv", "ortho_p", "Linv_p", "Rinv_p",
})


def _lead_rows(mesh, shape: Tuple[int, ...]) -> Sharding:
    entries: list = [None] * len(shape)
    if len(shape) >= 3 and "model" in mesh.axis_names:
        entries[0] = "model"
    if len(shape) >= 2 and "data" in mesh.axis_names:
        entries[-2] = "data"
    return named(mesh, constrain_spec(mesh, tuple(entries), shape))


def precond_cache_sharding(mesh, shape: Tuple[int, ...]) -> Sharding:
    """Cached preconditioners (Muon's "ortho" views, Shampoo's inverse
    roots, their "*_p" twins): the leading scanned-layer dim over model,
    the row dim over data, whatever the cache dtype."""
    return _lead_rows(mesh, tuple(shape))


def lowrank_basis_sharding(mesh, shape: Tuple[int, ...]) -> Sharding:
    """§14 rangefinder bases [..lead.., m, l]: the lead dim over model,
    the long side m over data, the sketch dim l never sharded."""
    return _lead_rows(mesh, tuple(shape))


def replicated(mesh) -> Sharding:
    return named(mesh, ())


def shardings_like(mesh, shapes_tree, ref_shardings_tree):
    """A reference sharding tree broadcast onto a tree of the same
    nesting; rank-0 leaves are replicated."""
    if isinstance(shapes_tree, dict):
        return {k: shardings_like(mesh, v, ref_shardings_tree[k])
                for k, v in shapes_tree.items()}
    return replicated(mesh) if not _shape_of(shapes_tree) \
        else ref_shardings_tree


# ------------------------------------------------------------------ blocks

def split_axes(sh: Optional[Sharding], dim: int) -> Tuple[str, ...]:
    """The mesh axes larger than 1 that split dim ``dim`` of a leaf under
    ``sh``, in mesh order (a dim's axes must be listed in mesh order)."""
    if sh is None or dim >= len(sh.spec):
        return ()
    axes = tuple(a for a in axes_of(sh.spec[dim]) if sh.mesh.shape[a] > 1)
    order = tuple(a for a in sh.mesh.axis_names if a in axes)
    if axes != order:
        raise ValueError(f"spec entry {sh.spec[dim]} lists mesh axes out "
                         f"of the mesh's order {sh.mesh.axis_names}")
    return axes


def sharded_axes(sh: Optional[Sharding]) -> Tuple[str, ...]:
    """Every mesh axis larger than 1 that splits some dim under ``sh``."""
    if sh is None:
        return ()
    return tuple(a for d in range(len(sh.spec)) for a in split_axes(sh, d))


def block_index(sh: Optional[Sharding], dim: int, coords
                ) -> Tuple[int, int]:
    """(parts, index): how many blocks ``sh`` splits dim ``dim`` into and
    which of them the rank at ``coords`` holds ((1, 0) when unsplit)."""
    for d, parts, idx in _splits(sh, dim + 1, coords):
        if d == dim:
            return parts, idx
    return 1, 0


def _splits(sh: Optional[Sharding], ndim: int, coords=None):
    """[(dim, parts, index)] of every split dim; ``index`` is the block
    ``coords`` (axis -> coordinate) holds, None without ``coords``."""
    out = []
    for dim in range(ndim):
        axes = split_axes(sh, dim)
        if not axes:
            continue
        parts, idx = 1, 0
        for a in axes:
            parts *= sh.mesh.shape[a]
            if coords is not None:
                idx = idx * sh.mesh.shape[a] + coords[a]
        out.append((dim, parts, idx if coords is not None else None))
    return out


def local_shape(shape: Tuple[int, ...], sh: Optional[Sharding]
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` leaf under ``sh``;
    raises on a dim that does not split evenly."""
    shape = list(int(d) for d in shape)
    for dim, parts, _ in _splits(sh, len(shape)):
        if shape[dim] % parts:
            raise ValueError(f"dim {dim} of a {tuple(shape)} leaf does not "
                             f"split into {parts} blocks ({sh.spec})")
        shape[dim] //= parts
    return tuple(shape)


def full_shape(shape: Tuple[int, ...], sh: Optional[Sharding]
               ) -> Tuple[int, ...]:
    """The whole leaf's shape from one block's ``shape`` under ``sh``."""
    shape = list(int(d) for d in shape)
    for dim, parts, _ in _splits(sh, len(shape)):
        shape[dim] *= parts
    return tuple(shape)


def local_block(x, sh: Optional[Sharding], coords):
    """The block of ``x`` (a numpy array or a torch tensor: the whole
    leaf) that the rank at ``coords`` (``Mesh.coords``) holds under
    ``sh``: a view, contiguous slices of every split dim."""
    local_shape(tuple(x.shape), sh)  # every split dim must divide
    for dim, parts, idx in _splits(sh, len(x.shape), coords):
        n = x.shape[dim] // parts
        sl = [slice(None)] * len(x.shape)
        sl[dim] = slice(idx * n, (idx + 1) * n)
        x = x[tuple(sl)]
    return x


def gather_full(x, sh: Optional[Sharding], *, kind: str = "gather"):
    """The whole leaf from every rank's block ``x`` under ``sh``: one
    all-gather a split dim, over the axes that split it (collective on
    every rank of the mesh; not differentiable, see
    ``collectives.gather_from``)."""
    from repro_torch import collectives

    for dim in range(x.dim()):
        axes = split_axes(sh, dim)
        if axes:
            x = collectives.all_gather(x, sh.mesh.group(axes), dim=dim,
                                       kind=kind)
    return x


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one nesting (dicts and
    lists, as a decode cache)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def cache_blocks(mesh, cfg: ModelConfig, cache, batch_size: int,
                 coords=None):
    """The rank at ``coords`` (this process's by default) its block of
    every leaf of a whole decode cache tree under ``cache_shardings(mesh,
    cfg, cache, batch_size)``: views, the tree's nesting kept."""
    coords = mesh.coords() if coords is None else coords
    return _map2(lambda x, sh: local_block(x, sh, coords), cache,
                 cache_shardings(mesh, cfg, cache, batch_size))


def gather_cache(blocks, shardings, *, kind: str = "gather"):
    """The whole decode cache from every rank's ``blocks`` under
    ``shardings`` (``cache_shardings`` of the whole cache): the inverse
    of ``cache_blocks``, one ``gather_full`` a leaf (collective)."""
    return _map2(lambda x, sh: gather_full(x, sh, kind=kind), blocks,
                 shardings)
