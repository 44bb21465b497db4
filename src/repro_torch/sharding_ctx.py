"""Logical activation-sharding context (counterpart of
``repro/sharding_ctx.py``).

The launcher installs (mesh, rules) with ``activation_sharding(...)``;
``current()`` returns the innermost pair, and the §8 engine
(``optim/bucketing.py::mesh_batch_axes``) reads its batch axes from it.

Model code annotates activations with logical axis names,
``shard_activation(x, ("batch", "seq", "embed"))``.  On the data axis
this returns ``x`` unchanged: each rank's activations are already its own
rows of the batch, and the parameters are replicated.  A mesh with a
model axis larger than 1 (tensor parallelism) raises: the DTensor path
through the model comes with ROADMAP.md Queue 1 item 11b.  The
reference's ``compat_shard_map`` has no counterpart: its bodies (the
matrix-function chains, ``int8_psum``) run on each rank as they are,
with the collectives of ``collectives.py``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

_CTX: list = []


def check_data_axis(mesh) -> None:
    """Raise unless ``mesh`` shards nothing but the batch (model = 1)."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"a mesh with model = {mesh.shape['model']} (tensor "
            f"parallelism, parameter sharding) comes with ROADMAP.md Queue 1 "
            f"item 11b; this port distributes the data axis only")


@contextlib.contextmanager
def activation_sharding(mesh, rules: Dict[str, Any]):
    check_data_axis(mesh)
    _CTX.append((mesh, rules))
    try:
        yield
    finally:
        _CTX.pop()


@contextlib.contextmanager
def suspend_activation_sharding():
    """Disable the context for the block (the reference's pipeline stages
    run under it)."""
    saved = list(_CTX)
    _CTX.clear()
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.extend(saved)


def current() -> Optional[Tuple[Any, Dict[str, Any]]]:
    return _CTX[-1] if _CTX else None


def shard_activation(x: torch.Tensor, axes: Tuple) -> torch.Tensor:
    """``x`` itself: on the data axis a rank's activations are its own
    rows (``activation_sharding`` refuses any other mesh)."""
    return x
