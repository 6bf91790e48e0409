"""A ``torch.distributed`` process group for CUDA tensors over gloo, with
every byte staged through pinned host buffers and counted.

One H100 takes one rank of NCCL, so the port's multi-rank runs on one
card are gloo ranks that all compute on ``cuda:0``.  Gloo's own CUDA
paths do not cover what the port calls (on torch 2.11 ``send`` and
``recv`` of CUDA tensors abort the process, and DTensor's all-gather,
reduce-scatter and all-to-all crash it), so :class:`StagedGlooGroup`
does every collective the same way: each CUDA input is copied into a
pinned host buffer, the CPU gloo backend runs the collective on the
host buffers, and each CUDA output is copied back from its host buffer.
CPU tensors go to gloo as they are.  The compute stays on the card;
only the transport crosses to the host.
:func:`repro_torch.launch.mesh.init_distributed` picks this group for
the ``cuda`` device type, in every run, and plain gloo for ``cpu``.

It implements every collective of the ``ProcessGroup`` interface that
gloo has (the functional collectives DTensor calls reach the coalesced
forms, under the names of torch 2.11 and of later versions), each with
the same staging.  Each group counts its collectives by name and the
bytes it staged each way (``counts``); :func:`staged_totals` sums them
over the groups of this process.  Every call but ``send`` completes
before it returns (the returned ``Work`` is already done); a ``send``
returns gloo's work on the host copy, so the ranks of a ring can all
send before they receive, and a receive posted before the matching send
of its own rank blocks.
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict, List

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import (ProcessGroupGloo,
                                        _create_work_from_future)
from torch.futures import Future

__all__ = ["BACKEND", "StagedGlooGroup", "staged_totals", "register"]

BACKEND = "repro_staged_gloo"

_GROUPS: "weakref.WeakSet[StagedGlooGroup]" = weakref.WeakSet()


def _done(result=None):
    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class StagedGlooGroup(dist.ProcessGroup):
    """A process group of ``size`` ranks whose collectives run on a CPU
    gloo backend built on the same store, CUDA tensors staged through
    pinned host memory (module docstring)."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = ProcessGroupGloo(dist.PrefixStore("staged/", store),
                                      rank, size, timeout)
        self.counts: Dict[str, int] = collections.Counter()
        _GROUPS.add(self)

    def getBackendName(self) -> str:
        return BACKEND

    # the base class reads the name from a registered C++ backend, which
    # this group has none of
    def _set_group_name(self, name: str) -> None:
        self._group_name = name
        super()._set_group_name(name)

    @property
    def group_name(self) -> str:
        return self._group_name

    # -- staging ------------------------------------------------------------
    def _in(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor holding ``t`` 's values (``t`` itself on the
        CPU)."""
        if t.device.type == "cpu":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.counts["bytes_to_host"] += t.numel() * t.element_size()
        return h

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A host buffer an output of ``t`` 's shape is received in."""
        if t.device.type == "cpu":
            return t
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def _back(self, t: torch.Tensor, h: torch.Tensor) -> None:
        if h is not t:
            t.copy_(h)
            self.counts["bytes_to_device"] += t.numel() * t.element_size()

    def _run(self, name: str, work) -> None:
        self.counts[name] += 1
        work.wait()

    # -- collectives ----------------------------------------------------------
    def allreduce(self, tensors: List[torch.Tensor], opts=None):
        hs = [self._in(t) for t in tensors]
        self._run("allreduce", self._gloo.allreduce(
            hs, opts or dist.AllreduceOptions()))
        for t, h in zip(tensors, hs):
            self._back(t, h)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        for t in tensors:
            self.allreduce([t], _allreduce_opts(opts))
        return _done(tensors)

    def broadcast(self, tensors, opts=None):
        hs = [self._in(t) for t in tensors]
        self._run("broadcast", self._gloo.broadcast(
            hs, opts or dist.BroadcastOptions()))
        for t, h in zip(tensors, hs):
            self._back(t, h)
        return _done(tensors)

    def allgather(self, output_lists, inputs, opts=None):
        hin = [self._in(t) for t in inputs]
        hout = [[self._out(t) for t in lst] for lst in output_lists]
        self._run("allgather", self._gloo.allgather(
            hout, hin, opts or dist.AllgatherOptions()))
        for lst, hl in zip(output_lists, hout):
            for t, h in zip(lst, hl):
                self._back(t, h)
        return _done(output_lists)

    def _allgather_base(self, output, input, opts=None):
        hin, hout = self._in(input), self._out(output)
        self._run("all_gather_into_tensor", self._gloo._allgather_base(
            hout, hin, opts or dist.AllgatherOptions()))
        self._back(output, hout)
        return _done(output)

    # torch 2.11 calls the one-tensor forms by their old names, later
    # versions by these
    all_gather_single = _allgather_base

    # the functional collectives (DTensor's) call the coalesced forms
    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def reduce_scatter(self, outputs, input_lists, opts=None):
        hout = [self._out(t) for t in outputs]
        hin = [[self._in(t) for t in lst] for lst in input_lists]
        self._run("reduce_scatter", self._gloo.reduce_scatter(
            hout, hin, opts or dist.ReduceScatterOptions()))
        for t, h in zip(outputs, hout):
            self._back(t, h)
        return _done(outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        hin, hout = self._in(input), self._out(output)
        self._run("reduce_scatter_tensor", self._gloo._reduce_scatter_base(
            hout, hin, opts or dist.ReduceScatterOptions()))
        self._back(output, hout)
        return _done(output)

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        hin, hout = self._in(input), self._out(output)
        self._run("all_to_all_single", self._gloo.alltoall_base(
            hout, hin, list(output_split_sizes or []),
            list(input_split_sizes or []), opts or dist.AllToAllOptions()))
        self._back(output, hout)
        return _done(output)

    def alltoall(self, outputs, inputs, opts=None):
        hin = [self._in(t) for t in inputs]
        hout = [self._out(t) for t in outputs]
        self._run("all_to_all", self._gloo.alltoall(
            hout, hin, opts or dist.AllToAllOptions()))
        for t, h in zip(outputs, hout):
            self._back(t, h)
        return _done(outputs)

    def scatter(self, outputs, input_lists, opts=None):
        hout = [self._out(t) for t in outputs]
        hin = [[self._in(t) for t in lst] for lst in input_lists]
        self._run("scatter", self._gloo.scatter(
            hout, hin, opts or dist.ScatterOptions()))
        for t, h in zip(outputs, hout):
            self._back(t, h)
        return _done(outputs)

    def gather(self, output_lists, inputs, opts=None):
        hin = [self._in(t) for t in inputs]
        hout = [[self._out(t) for t in lst] for lst in output_lists]
        self._run("gather", self._gloo.gather(
            hout, hin, opts or dist.GatherOptions()))
        for lst, hl in zip(output_lists, hout):
            for t, h in zip(lst, hl):
                self._back(t, h)
        return _done(output_lists)

    def reduce(self, tensors, opts=None):
        hs = [self._in(t) for t in tensors]
        self._run("reduce", self._gloo.reduce(
            hs, opts or dist.ReduceOptions()))
        for t, h in zip(tensors, hs):
            self._back(t, h)
        return _done(tensors)

    def send(self, tensors, dst: int, tag: int = 0):
        # not waited: gloo's work keeps the host copy until it is sent, so
        # a ring of sends followed by receives does not block on itself
        self.counts["send"] += 1
        return self._gloo.send([self._in(t) for t in tensors], dst, tag)

    def recv(self, tensors, src: int, tag: int = 0):
        hs = [self._out(t) for t in tensors]
        self._run("recv", self._gloo.recv(hs, src, tag))
        for t, h in zip(tensors, hs):
            self._back(t, h)
        return _done(tensors)

    def barrier(self, opts=None):
        self._run("barrier", self._gloo.barrier(
            opts or dist.BarrierOptions()))
        return _done()


def _allreduce_opts(opts):
    """``AllreduceOptions`` carrying a coalesced call's reduce op."""
    out = dist.AllreduceOptions()
    if opts is not None:
        out.reduceOp = opts.reduceOp
    return out


def staged_totals() -> Dict[str, int]:
    """Collectives by name and bytes staged each way, summed over this
    process's staged groups."""
    out: Dict[str, int] = collections.Counter()
    for g in list(_GROUPS):
        out.update(g.counts)
    return dict(out)


def register() -> None:
    """Register :data:`BACKEND` with ``torch.distributed`` (for the cpu
    and cuda device types; idempotent)."""
    if BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(BACKEND, StagedGlooGroup,
                                      devices=["cpu", "cuda"])
