"""Device meshes — the port's counterpart of the JAX package's
``launch/mesh.py``.

:func:`make_production_mesh` and :func:`make_test_mesh` return a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
with named dims over the ranks of the default process group (one process
a mesh position), as ``jax.make_mesh`` returns a mesh over devices; the
specs of :mod:`repro_torch.models.sharding` place DTensors on it.
:func:`init_distributed` starts that group with the backend the device
type takes: gloo for ``cpu``; for ``cuda``, gloo with every tensor
staged through pinned host memory
(:mod:`repro_torch.launch.staged_gloo`), so several ranks can share one
card, which NCCL refuses.

A :class:`DataMesh` is an ordered tuple of ``torch.device`` s on one
axis, ``"data"``: the placement slots that
:class:`~repro_torch.serving.signal_mesh.SignalMesh` splits bucket
batches over and homes streaming sessions on.  It holds no process group
and runs no collective — a meshed service issues one call per slot from
one process, as the JAX package's single-controller mesh does.  A caller
may list the same device several times (``DataMesh(["cpu"] * 4)``): N
placement slots on one device, the counterpart of the JAX package's
forced host devices, on which the per-slot split and gather really run.
"""

from __future__ import annotations

import datetime
import math
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DEFAULT_DEVICE, resolve_device
from . import staged_gloo

__all__ = ["DataMesh", "make_data_mesh", "make_test_mesh",
           "make_production_mesh", "init_distributed"]


class DataMesh:
    """A 1-D mesh over the ``"data"`` axis: ``devices`` in slot order,
    ``shape == (len(devices),)``.  Each device is resolved as the port's
    entry points resolve one (:func:`repro_torch.device.resolve_device`:
    a CUDA device on a host without a card raises)."""

    axis_names: Tuple[str, ...] = ("data",)

    def __init__(self, devices: Iterable):
        self.devices: Tuple[torch.device, ...] = tuple(
            resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a DataMesh needs at least one device")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.devices),)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DataMesh({[str(d) for d in self.devices]})"


def make_data_mesh(n_devices: Optional[int] = None,
                   device=DEFAULT_DEVICE) -> DataMesh:
    """1-D data-parallel mesh over the local devices of ``device`` 's
    type: the first ``n_devices`` visible CUDA devices (all by default),
    or the host's one CPU device when the caller names the CPU.  Asking
    for more devices than the host has raises, as ``jax.make_mesh``
    does."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = [torch.device(dev.type)]
    n = int(n_devices) if n_devices else len(avail)
    if not 1 <= n <= len(avail):
        raise ValueError(f"make_data_mesh: {n} devices requested, "
                         f"{len(avail)} {dev.type} device(s) visible")
    return DataMesh(avail[:n])


def init_distributed(rank: int, world_size: int, init_method: str,
                     device=DEFAULT_DEVICE,
                     timeout_s: float = 120.0) -> None:
    """Join the default process group as ``rank`` of ``world_size`` at
    ``init_method`` (``file://...`` or ``tcp://localhost:<port>``) with
    the backend of ``device`` 's type: gloo for the CPU; for CUDA
    :data:`~repro_torch.launch.staged_gloo.BACKEND`, on the current
    device (every rank of one card on ``cuda:0``).  Collectives that wait
    longer than ``timeout_s`` raise."""
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        staged_gloo.register()
        backend = staged_gloo.BACKEND
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _device_mesh(shape, axes, device) -> DeviceMesh:
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs the default process group "
                           "(init_distributed)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=DEFAULT_DEVICE) -> DeviceMesh:
    """Single pod: (16, 16) over ``("data", "model")``; multi-pod:
    (2, 16, 16) over ``("pod", "data", "model")`` — 256 or 512 ranks.  A
    world of another size raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device=DEFAULT_DEVICE) -> DeviceMesh:
    """A small mesh over the ranks of the default process group (the
    multi-rank tests' ``(2, 2)``, ``(2, 4)``, ``(4, 1)``).  A world of
    another size raises."""
    return _device_mesh(shape, axes, device)
