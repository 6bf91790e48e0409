"""The serving stack's device mesh — the port's counterpart of the JAX
package's ``launch/mesh.py`` ``make_data_mesh``.

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

from typing import Iterable, Optional, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["DataMesh", "make_data_mesh"]


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
