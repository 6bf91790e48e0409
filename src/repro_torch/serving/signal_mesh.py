"""SigMesh: the data-parallel execution domain of a meshed
:class:`~repro_torch.serving.signal_service.SignalService` — the port's
counterpart of the JAX package's ``serving/signal_mesh.py``.

Two pieces, deliberately separable:

  * :class:`SignalMesh` — the *placement* layer.  Wraps a 1-D
    :class:`~repro_torch.launch.mesh.DataMesh` over the ``data`` axis
    and splits bucket batches into per-slot row blocks on each slot's
    device (:func:`repro_torch.models.sharding.split_rows`, the split
    :meth:`CompiledSignalGraph.sharded_jit` runs, under the same
    degrade-to-replicate rules as training batches).  Row counts pad up to a multiple of the
    **logical shard count** with zero rows — every compiled graph is
    row-independent, so pad rows compute values nothing reads back.
    ``n_shards`` may exceed the device count: shards then co-locate,
    wrapping round-robin over the devices.  On one card, ``SignalMesh(4)``
    spans one device, as the JAX package's does over one jax device: a
    meshed wave is one call on the padded rows, and the routing,
    occupancy and affinity logic runs unchanged.
  * :class:`DeviceRouter` — the *accounting* layer, pure host-side
    state.  Least-loaded assignment of streaming sessions to shard
    indices (device affinity: a session's carried ``StreamState`` stays
    on its shard's device across ticks), a per-shard cycle ledger fed by
    the perf model (:func:`repro_torch.core.perf_model.device_step_costs`),
    and liveness flags so a dropped shard stops receiving work.

Everything runs in one process: a meshed service issues one call per
slot, and no collective is involved.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DEFAULT_DEVICE
from ..launch.mesh import DataMesh, make_data_mesh
from ..models.sharding import NamedSharding, row_sharding, split_rows

__all__ = ["SignalMesh", "DeviceRouter", "trim_rows"]


class SignalMesh:
    """Data-parallel placement for :class:`SignalService`.

    ``n_shards`` is the logical data-parallel width (default: the number
    of visible devices of ``device`` 's type — the card's, unless the
    caller names the CPU).  The mesh spans ``min(n_shards, visible)``
    placement slots on one ``data`` axis; when ``n_shards`` exceeds
    them, shards wrap over the slots (placement degrades, the math does
    not).  ``mesh`` adopts an explicit :class:`DataMesh` instead,
    ``n_shards`` defaulting to its slot count."""

    def __init__(self, n_shards: Optional[int] = None,
                 mesh: Optional[DataMesh] = None, device=DEFAULT_DEVICE):
        if mesh is not None:
            self.mesh = mesh
            self.n_shards = int(n_shards or mesh.size)
        else:
            visible = make_data_mesh(device=device).size
            self.n_shards = int(n_shards or visible)
            if self.n_shards < 1:
                raise ValueError("n_shards must be >= 1")
            self.mesh = make_data_mesh(min(self.n_shards, visible), device)
        self.devices: List[torch.device] = list(self.mesh.devices)

    @classmethod
    def coerce(cls, mesh, device=DEFAULT_DEVICE) -> Optional["SignalMesh"]:
        """``None`` | ``SignalMesh`` | shard count | :class:`DataMesh` ->
        ``SignalMesh`` (or None): the service constructor's adapter.  A
        shard count builds the mesh over ``device`` 's type."""
        if mesh is None or isinstance(mesh, cls):
            return mesh
        if isinstance(mesh, int):
            return cls(n_shards=mesh, device=device)
        if isinstance(mesh, DataMesh):
            return cls(mesh=mesh)
        raise TypeError(f"SigMesh takes mesh=None, a shard count, a "
                        f"SignalMesh or a DataMesh; got "
                        f"{type(mesh).__name__}")

    # -- bucket-batch sharding ---------------------------------------------
    def padded_rows(self, rows: int) -> int:
        """Rows after padding up to a multiple of the shard count."""
        return max(1, math.ceil(rows / self.n_shards)) * self.n_shards

    def align_row_budget(self, budget: Optional[int]) -> Optional[int]:
        """A scheduler row budget rounded UP to a shard multiple (and
        never below one full shard round).  Splitting a wave at a
        non-multiple chunk size would add zero pad rows to EVERY chunk,
        so the preemptible scheduler aligns its chunks to the shard
        width and pays the row padding at most once, on the remainder
        chunk."""
        if budget is None:
            return None
        return self.padded_rows(max(1, int(budget)))

    def row_sharding(self, shape) -> NamedSharding:
        """The sharding splitting the leading (batch) axis over the
        mesh's data axis; replicated if the row count does not divide
        (the same degrade rules as training batches)."""
        return row_sharding(self.mesh, tuple(shape))

    def shard(self, arr) -> Tuple[torch.Tensor, ...]:
        """A (rows-padded) batch split by :meth:`row_sharding` into
        per-slot row blocks, each on its slot's device, in slot order;
        one block on the first slot when the rows do not divide
        (:func:`~repro_torch.models.sharding.split_rows`, as
        :meth:`CompiledSignalGraph.sharded_jit` splits).  Pads nothing
        itself."""
        x = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(arr)
        return split_rows(self.mesh, x)

    # -- streaming-session affinity ----------------------------------------
    def device_for(self, shard_index: int) -> torch.device:
        """The device backing a logical shard index (shards beyond the
        slot count wrap round-robin)."""
        return self.devices[shard_index % len(self.devices)]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SignalMesh(n_shards={self.n_shards}, "
                f"devices={len(self.devices)})")


class DeviceRouter:
    """Host-side shard router and per-device occupancy ledger.

    ``assign()`` picks the least-loaded *alive* shard (stable tie-break:
    lowest index) — the service calls it once per ``open_stream``,
    giving the session device affinity for life; ``charge()``
    accumulates perf-model cycles per shard as work executes.  ``drop()``
    marks a shard dead (simulated device loss): it stops receiving
    assignments and the service re-homes its sessions.  Everything is
    plain ints, so routing properties are testable without any
    multi-device runtime.
    """

    def __init__(self, n_devices: int):
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        self.n_devices = int(n_devices)
        self.device_cycles: List[int] = [0] * self.n_devices
        self.device_sessions: List[int] = [0] * self.n_devices
        self.alive: List[bool] = [True] * self.n_devices

    def assign(self, cost_hint: int = 0) -> int:
        """Least-loaded alive shard — fewest assigned sessions first (so
        a burst of opens spreads before any work runs), then fewest spent
        cycles, then lowest index.  ``cost_hint`` (optional) charges the
        expected cost at assignment time."""
        alive = [i for i in range(self.n_devices) if self.alive[i]]
        if not alive:
            raise RuntimeError("no alive devices to assign to")
        idx = min(alive, key=lambda i: (self.device_sessions[i],
                                        self.device_cycles[i], i))
        self.device_sessions[idx] += 1
        if cost_hint:
            self.device_cycles[idx] += int(cost_hint)
        return idx

    def release(self, index: Optional[int]) -> None:
        """A session left its shard (closed or re-homed)."""
        if index is not None and self.device_sessions[index] > 0:
            self.device_sessions[index] -= 1

    def charge(self, index: int, cycles: int) -> None:
        self.device_cycles[index] += int(cycles)

    def drop(self, index: int) -> None:
        """Mark a shard dead.  Its ledger survives (the cycles were
        really spent); it just stops receiving work."""
        self.alive[index] = False

    def alive_count(self) -> int:
        return sum(self.alive)

    def occupancy(self) -> Dict:
        """Per-device cycle shares — the per-device counterpart of
        ``CoScheduler.occupancy()``."""
        total = sum(self.device_cycles)
        return {
            "device_cycles": list(self.device_cycles),
            "device_share": [c / total if total else 0.0
                             for c in self.device_cycles],
            "sessions": list(self.device_sessions),
            "alive": list(self.alive),
            "total_cycles": total,
        }


def trim_rows(out, rows: int):
    """Drop pad rows from a (possibly multi-output) batched result — the
    inverse of :meth:`SignalMesh.padded_rows` padding.  A multi-output
    dict keeps its order (outputs, then taps)."""
    if isinstance(out, dict):
        return {k: v[:rows] for k, v in out.items()}
    return out[:rows]
