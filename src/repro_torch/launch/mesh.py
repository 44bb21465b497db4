"""Meshes and the process group (counterpart of ``repro/launch/mesh.py``).

A ``Mesh`` names the axes of a world of ranks: ``("data", "model")``, or
``("pod", "data", "model")`` across pods, with the reference's shapes.
Its ``shape`` (axis -> size) and ``axis_names`` need no process group, so
the sharding rules (``launch/sharding.py``) run on any mesh shape, the
production meshes included.  Inside a world (``init_world``) the mesh
also holds ``device_mesh``, a ``torch.distributed.device_mesh.DeviceMesh``
over the current process group with the same named dimensions, and
``group(axes)`` gives the process group the collectives of those axes
run over (``collectives.py``): every subset of the axes has its groups,
built when the mesh is built (``dist.new_group`` is collective, so every
rank creates them all in the same order).  ``coords(rank)`` is a rank's
row-major coordinate on each axis, the order the groups list their
ranks in.

The backend is chosen explicitly and printed: NCCL only when every rank
has a CUDA device of its own; gloo on the CPU and for ranks that share a
CUDA device (NCCL refuses two ranks on one device; gloo stages CUDA
tensors through the host inside each collective).  The process group
carries a timeout, so a hung collective fails the run instead of
blocking it.  The reference's ``compat_*`` shims existed for JAX versions
and have no counterpart.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: how long a collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 300.0

_WORLD: Dict[str, object] = {}


def choose_backend(device: torch.device, world_size: int
                   ) -> Tuple[str, str]:
    """(backend, why) for ranks on ``device``: nccl only when every rank
    has a CUDA device of its own, gloo otherwise."""
    if device.type != "cuda":
        return "gloo", "CPU tensors"
    n_dev = torch.cuda.device_count()
    own = world_size <= n_dev
    why = (f"{world_size} ranks on {n_dev} CUDA device(s), "
           + ("a device each" if own else "sharing a device"))
    return ("nccl" if own else "gloo"), why


def init_world(rank: int, world_size: int, init_method: str, *,
               device=None, timeout_s: float = DEFAULT_TIMEOUT_S
               ) -> torch.device:
    """Join a world of ``world_size`` ranks as ``rank``; returns this
    rank's device.

    ``init_method`` is ``file://<path>``, ``tcp://localhost:<port>`` or
    ``env://`` (``init_world_from_env``: torchrun's variables).  ``device`` is CUDA
    unless named (``device.resolve_device``); rank r takes CUDA device
    r mod the device count.  Prints the backend and why it was chosen."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend, why = choose_backend(dev, world_size)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _WORLD.update(device=dev, backend=backend)
    print(f"[mesh] rank {rank}/{world_size}: backend {backend} ({why}), "
          f"device {dev}, timeout {timeout_s:g} s", flush=True)
    return dev


#: the variables torchrun sets for ``env://``
ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_world_from_env(*, device=None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the world torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) through ``env://``; raises
    ValueError when the environment names no world."""
    missing = [v for v in ENV_VARS if v not in os.environ]
    if missing:
        raise ValueError(f"no world in the environment: {missing} unset "
                         f"(run under torchrun)")
    return init_world(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                      "env://", device=device, timeout_s=timeout_s)


def close_world() -> None:
    """Leave the world ``init_world`` joined (a no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.clear()


def world_backend() -> Optional[str]:
    """The backend ``init_world`` chose, None outside a world."""
    return _WORLD.get("backend")  # type: ignore[return-value]


class Mesh:
    """A mesh of named axes.  ``shape`` maps axis -> size in axis order;
    ``device_mesh`` is a DeviceMesh over the current process group inside
    a world, else None (a mesh of shape only)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if world != self.size:
                raise ValueError(f"a {tuple(shape)} mesh needs {self.size} "
                                 f"ranks; the world has {world}")
            from torch.distributed.device_mesh import init_device_mesh

            dev = _WORLD.get("device")
            self.device_mesh = init_device_mesh(
                dev.type if dev is not None else "cpu", tuple(shape),
                mesh_dim_names=self.axis_names)
            self._build_groups()

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``rank``'s coordinate on each axis (row-major: the last axis
        varies fastest); this process's rank by default."""
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        out, stride = {}, 1
        for ax in reversed(self.axis_names):
            out[ax] = (rank // stride) % self.shape[ax]
            stride *= self.shape[ax]
        return {ax: out[ax] for ax in self.axis_names}

    def _build_groups(self) -> None:
        """One process group for every proper subset of two or more axes
        and every setting of the other axes, created on every rank in the
        same order; one axis takes its DeviceMesh dimension's group."""
        me = dist.get_rank()
        names = self.axis_names
        for k in range(2, len(names)):
            for sub in itertools.combinations(names, k):
                rest = [a for a in names if a not in sub]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = [r for r in range(self.size)
                             if all(self.coords(r)[a] == v
                                    for a, v in zip(rest, fixed))]
                    g = dist.new_group(ranks)
                    if me in ranks:
                        self._groups[sub] = g

    def group(self, axes: Sequence[str]):
        """The process group the collectives over ``axes`` run in: the
        ranks that share this rank's coordinates on every other axis,
        listed in row-major order over ``axes``."""
        if self.device_mesh is None:
            raise RuntimeError(f"{self!r} has no process group: call "
                               f"init_world first")
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        if math.prod(self.shape[a] for a in axes) == self.size:
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]


def _axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (data=16, model=16) a pod; across
    pods a leading pure data-parallel "pod" axis (2 pods)."""
    return Mesh((2, 16, 16) if multi_pod else (16, 16), _axes(multi_pod))


def make_debug_mesh(data: int = 2, model: int = 2, *,
                    multi_pod: bool = False, pods: int = 2) -> Mesh:
    """A small mesh: (data, model), or (pods, data, model)."""
    return Mesh((pods, data, model) if multi_pod else (data, model),
                _axes(multi_pod))
