"""Logical activation-sharding context (counterpart of
``repro/sharding_ctx.py``).

The launcher installs (mesh, rules) with ``activation_sharding(...)``;
``current()`` returns the innermost pair, and the §8 engine
(``optim/bucketing.py::mesh_batch_axes``) reads its batch axes from it.

Model code annotates activations with logical axis names,
``shard_activation(x, ("batch", "seq", "embed"), full_shape)``.  The
port's tensor parallelism is explicit (``models/``: column- and
row-parallel projections with the collectives of ``collectives.py``), so
the code, not the annotation, fixes a rank's layout: the annotation is
an assertion.  With the global shape given, it checks that ``x``'s
local shape is that shape split by the active rules, raises on a
mismatch, and returns ``x``.  The reference's ``compat_shard_map`` has
no counterpart: its bodies (the matrix-function chains, ``int8_psum``)
run on each rank as they are, with the collectives of
``collectives.py``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

_CTX: list = []


@contextlib.contextmanager
def activation_sharding(mesh, rules: Dict[str, Any]):
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


def shard_activation(x: torch.Tensor, axes: Tuple,
                     full_shape: Optional[Tuple[int, ...]] = None
                     ) -> torch.Tensor:
    """``x`` itself.  Under a context and with ``full_shape`` (the global
    shape), raises unless ``x``'s shape is ``full_shape`` split by the
    rules' mesh axes for ``axes`` (the layout the explicit code must have
    produced)."""
    ctx = current()
    if ctx is None or full_shape is None:
        return x
    from repro_torch.launch import sharding

    mesh, rules = ctx
    spec = sharding.constrain_spec(
        mesh, sharding.spec_from_axes(tuple(axes), rules), tuple(full_shape))
    want = sharding.local_shape(tuple(full_shape),
                                sharding.named(mesh, spec))
    if tuple(x.shape) != want:
        raise ValueError(f"activation {tuple(axes)}: local shape "
                         f"{tuple(x.shape)}, the rules give {want} of "
                         f"{tuple(full_shape)}")
    return x
