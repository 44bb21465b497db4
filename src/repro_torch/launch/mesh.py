"""Meshes and the process group (counterpart of ``repro/launch/mesh.py``).

A ``Mesh`` names the axes of a world of ranks: ``("data", "model")``, or
``("pod", "data", "model")`` across pods, with the reference's shapes.
Its ``shape`` (axis -> size) and ``axis_names`` need no process group, so
the sharding rules (``launch/sharding.py``) run on any mesh shape, the
production meshes included.  Inside a world (``init_world``) the mesh
also holds ``device_mesh``, a ``torch.distributed.device_mesh.DeviceMesh``
over the current process group with the same named dimensions, and
``group(axes)`` gives the process group the collectives of those axes
run over (``collectives.py``).

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
import math
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

    ``init_method`` is ``file://<path>`` or ``tcp://localhost:<port>``
    (nothing on the machine announces a cluster).  ``device`` is CUDA
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

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def group(self, axes: Sequence[str]):
        """The process group the collectives over ``axes`` run in.  Axes
        that hold every rank of more than one give the world; one axis its
        DeviceMesh dimension."""
        if self.device_mesh is None:
            raise RuntimeError(f"{self!r} has no process group: call "
                               f"init_world first")
        axes = tuple(axes)
        if math.prod(self.shape[a] for a in axes) == self.size:
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        raise NotImplementedError(
            f"collectives over {axes} of {self!r} (part of the world over "
            f"several axes) come with model-axis sharding, ROADMAP.md "
            f"Queue 1 item 11b")


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
