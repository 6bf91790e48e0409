"""Signal-graph serving: continuous-batched DSP requests and streaming
sessions.

The port's counterpart of the JAX package's ``serving/signal_service.py``:

  * :class:`SignalService` — registry of named :class:`SignalGraph`
    pipelines with a continuous-batching request loop.  Mixed-length
    requests are padded up to a small set of compile-cached **bucket**
    lengths (powers of two, or config-supplied) and batched per
    ``(graph, bucket)``; per-request valid-frame masks are threaded
    through the compiled graph (:meth:`CompiledSignalGraph.masked_jit`)
    so padded results equal unpadded execution — the stage kinds whose
    rows are computed independently (FFT butterflies, FIR taps on the
    shuffle-GEMM kernels, pointwise glue) give the same values; the mask
    CNN's convolution may pick another algorithm per shape and agrees to
    float32 rounding.  New requests join the next step's wave: the wave
    is re-formed from the live queue every step.
  * :class:`StreamSession` — a per-connection streaming handle
    (:meth:`SignalService.open_stream`): chunked submissions accumulate
    in per-connection :class:`~repro_torch.signal.streaming.StreamState`
    s, and every :meth:`SignalService.stream_step` stacks the ready
    blocks of same-graph sessions — and, with the scheduler's cross-graph
    batching, of graphs whose streamed cores fingerprint alike and whose
    registered params are equal — into ONE core call.  ``read()`` returns
    host numpy, one device-to-host copy a session a tick.
  * Durability: :meth:`SignalService.checkpoint` / :meth:`restore` take
    and load a host snapshot of every open session, and
    :meth:`save_checkpoint` / :meth:`restore_from_disk` persist it
    through :class:`repro_torch.checkpoint.Checkpointer`, so a stream
    survives the death of its process with exactly-once delivery.

Both paths carry the SigProgram multi-output contract: graphs declared
with ``outputs()``/``tap()`` return per-output dicts from :meth:`step` /
:meth:`serve` (each output trimmed back to the request's true length
along its own frames/time axis) and from :meth:`StreamSession.read` /
``close`` (frame taps emitted per block).

Calibrated programs are served with ``precision=`` (a SigQuant
:class:`~repro_torch.signal.backends.PrecisionPolicy`): every bucket
compile and every streaming core int-routes the policy's steps through
the bitserial kernel.

Every :meth:`SignalService.step` is dispatched by
:class:`~repro_torch.serving.scheduler.SigSched`, the default as in the
JAX package: cross-graph batching by program fingerprint (rows whose
graphs registered different params run per-row in the same launches),
EDF with slack deferral, bucket promotion and an anti-starvation
override, and preemptible waves under a ``row_budget``.
``scheduler=False`` keeps the FIFO pick (the oldest request's ``(graph,
bucket)`` group in arrival order, up to ``batch_size``; streaming
sessions stack per graph), which the default reduces to with one graph
and no deadlines.

``mesh=`` serves data-parallel over a
:class:`~repro_torch.serving.signal_mesh.SignalMesh` (SigMesh, as in the
JAX package): waves pad their rows to a shard multiple with zero rows,
run one call per placement slot (:meth:`CompiledSignalGraph.sharded_jit`)
and are trimmed before any result is read; streaming sessions get a
shard for life from a :class:`~repro_torch.serving.signal_mesh.
DeviceRouter`, which also keeps the per-device cycle ledger
(``CoScheduler.occupancy()["per_device"]``) and re-homes the sessions of
a dropped shard (:meth:`SignalService.drop_device`).

:class:`CoScheduler` runs one step loop over LLM decode waves
(:class:`~repro_torch.serving.engine.DecodeWave`) and this service's DSP
waves and stream ticks, under a :class:`SchedulePolicy`:
``round_robin``, ``latency_aware`` (EDF across both classes) or
``cost_balanced`` (an occupancy split of perf-model cycles), as in the
JAX package.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..device import DEFAULT_DEVICE, resolve_device
from ..launch.mesh import DataMesh
from ..signal.graph import CompiledSignalGraph, FuseLevel, SignalGraph
from ..signal.streaming import (StreamState, StreamStructure,
                                commit_frames, drain_state, finalize_piece,
                                push_chunk, ready_spec, restore_state,
                                snapshot_state, take_block, tap_rows)
from ..tree import tree_leaves, tree_map, tree_structure
from .engine import DecodeWave, Request, ServingEngine
from .scheduler import SigSched
from .signal_mesh import DeviceRouter, SignalMesh, trim_rows

__all__ = ["SignalRequest", "SignalService", "StreamSession", "GroupInfo",
           "SigSched", "TickPlan", "SchedulePolicy", "RoundRobinPolicy",
           "LatencyAwarePolicy", "CostBalancedPolicy", "get_policy",
           "CoScheduler", "SignalMesh", "DeviceRouter"]


def _host(a) -> np.ndarray:
    """One tensor (or host array) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _params_equal(a, b) -> bool:
    """True when two params trees are interchangeable for execution:
    same structure, equal leaves (exact equality of shape, type and
    values — scheduling must never change results, so 'close enough' is
    not equal).  The JAX package's ``_params_equal`` over
    :mod:`repro_torch.tree`."""
    if a is b:
        return True
    if tree_structure(a) != tree_structure(b):
        return False
    # leaf pairs on one device are compared there and read back once
    on_device = []
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if _leaf_sig(x) != _leaf_sig(y):
            return False
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
                and x.device == y.device:
            on_device.append((x == y).all())
        elif not np.array_equal(_host(x), _host(y)):
            return False
    return not on_device or bool(torch.stack(on_device).all())


def _split_by_params(items) -> List[Tuple[object, List]]:
    """``[(params, item)]`` -> ``[(params, [items])]``: items grouped by
    :func:`_params_equal` of their params, in first-seen order, each
    distinct params object compared once."""
    classes: List[Tuple[object, List]] = []
    seen: Dict[int, List] = {}
    for p, item in items:
        members = seen.get(id(p))
        if members is None:
            members = next((m for cp, m in classes
                            if _params_equal(cp, p)), None)
            if members is None:
                members = []
                classes.append((p, members))
            seen[id(p)] = members
        members.append(item)
    return classes


def _leaf_sig(leaf) -> Tuple:
    """A params leaf's (shape, type name), without a device read."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr.shape, str(arr.dtype)


def _device_leaf(leaf, device) -> torch.Tensor:
    """One params leaf as a tensor on ``device`` (host float64 narrows to
    float32, the JAX package's default precision)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    arr = np.asarray(leaf)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


def _to_host(out):
    """Device results -> numpy, preserving the per-output dict of
    multi-output SigPrograms."""
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    return _host(out)


def _ckpt_encode(obj, _leaves=None):
    """Split a :meth:`SignalService.checkpoint` tree into a JSON-able
    structure encoding plus a flat list of array leaves (what
    :class:`~repro_torch.checkpoint.Checkpointer` stores as
    ``leaf_*.npy``).  Handles the snapshot vocabulary: dicts
    (string-or-None keys), lists, tuples, :class:`StreamState` s, numpy
    arrays and JSON scalars.  Returns ``(encoding, leaves)``; inverse is
    :func:`_ckpt_decode`."""
    top = _leaves is None
    leaves = [] if top else _leaves
    if isinstance(obj, StreamState):
        enc = {"__k__": "state",
               "pre": _ckpt_encode(list(obj.pre), leaves),
               "post": _ckpt_encode(list(obj.post), leaves),
               "buf": _ckpt_encode(obj.buf, leaves),
               "tail": _ckpt_encode(obj.tail, leaves),
               "counters": [int(obj.buf_start), int(obj.total),
                            int(obj.f_next), int(obj.emitted),
                            [int(d) for d in obj.batch_shape]]}
    elif isinstance(obj, np.ndarray):
        leaves.append(obj)
        enc = {"__k__": "leaf", "i": len(leaves) - 1}
    elif isinstance(obj, dict):
        enc = {"__k__": "dict",
               "items": [[k, _ckpt_encode(v, leaves)]
                         for k, v in obj.items()]}
    elif isinstance(obj, (list, tuple)):
        enc = {"__k__": "list" if isinstance(obj, list) else "tuple",
               "items": [_ckpt_encode(v, leaves) for v in obj]}
    elif isinstance(obj, np.integer):
        enc = int(obj)
    elif isinstance(obj, np.floating):
        enc = float(obj)
    else:
        enc = obj                       # int / float / str / bool / None
    return (enc, leaves) if top else enc


def _ckpt_decode(enc, leaves):
    """Inverse of :func:`_ckpt_encode` (array leaves stay numpy)."""
    if isinstance(enc, dict) and "__k__" in enc:
        k = enc["__k__"]
        if k == "leaf":
            return np.asarray(leaves[enc["i"]])
        if k == "dict":
            return {kk: _ckpt_decode(v, leaves)
                    for kk, v in enc["items"]}
        if k == "list":
            return [_ckpt_decode(v, leaves) for v in enc["items"]]
        if k == "tuple":
            return tuple(_ckpt_decode(v, leaves) for v in enc["items"])
        if k == "state":
            c = enc["counters"]
            return StreamState(
                pre=tuple(_ckpt_decode(enc["pre"], leaves)),
                post=tuple(_ckpt_decode(enc["post"], leaves)),
                buf=_ckpt_decode(enc["buf"], leaves),
                tail=_ckpt_decode(enc["tail"], leaves),
                buf_start=c[0], total=c[1], f_next=c[2], emitted=c[3],
                batch_shape=tuple(c[4]))
        raise ValueError(f"unknown checkpoint node kind {k!r}")
    return enc


@dataclasses.dataclass
class SignalRequest:
    rid: int
    graph: str
    samples: np.ndarray            # (T,) one channel of signal
    deadline: float = math.inf     # scheduler hint (SigSched's EDF)
    done: bool = False
    error: Optional[str] = None    # set when the service drops the request
    seq: int = -1                  # arrival order (assigned by submit)


@dataclasses.dataclass
class _Registration:
    graph: SignalGraph
    params: object
    struct: Optional[StreamStructure]   # None => not bucketable/streamable


@dataclasses.dataclass(frozen=True)
class GroupInfo:
    """One pending batch group: requests sharing a (graph, length-bucket)
    compiled program."""
    key: Tuple[str, int]
    count: int
    oldest_seq: int
    earliest_deadline: float




class SignalService:
    """Continuous-batched serving of registered signal graphs.

    Compiled graphs are cached per ``(graph, bucket)`` — requests of any
    length up to a bucket share that bucket's compiled program, padded
    and masked back to the unpadded results.  ``buckets`` optionally
    pins the admissible lengths (sorted ascending); the default is
    powers of two.  Graphs whose math is not local in time (a
    ``dct``/``fft``/``dwt`` over the raw input axis) cannot be masked
    and fall back to exact-length grouping; ``bucketing=False`` forces
    that for all graphs.

    ``backend`` selects the execution backend of every compiled program
    (``"reference"`` plain torch, ``"hopper"`` the CUDA kernels);
    ``device`` where it runs (``"cuda"`` by default, raising on a host
    without a card).  ``precision`` serves a calibrated program: the
    hopper backend is rebuilt with the policy, which is part of the
    backend's ``cache_key``, so bucket compiles key on it and served
    results equal the offline compile under the same policy; any other
    backend raises ``ValueError``.

    The backend, the precision policy and the device serve streaming
    sessions too: ``block_frames`` is the default number of new frames a
    session's core call finalizes (:meth:`open_stream`), and every
    session's carried state lives on the service's device.

    ``scheduler`` picks each :meth:`step`'s wave: ``None`` or ``True``
    (the default) builds a :class:`SigSched`, a dict passes it options,
    an instance is adopted, ``False`` keeps the FIFO pick.

    ``mesh`` shards the service data-parallel
    (:class:`~repro_torch.serving.signal_mesh.SignalMesh`; a shard count,
    built over ``device`` 's type, or a
    :class:`~repro_torch.launch.mesh.DataMesh` coerce).  Bucket batches
    pad their row count to a shard multiple with zero rows and run one
    call per placement slot; streaming sessions get device affinity (a
    least-loaded shard assigned at :meth:`open_stream`, whose device then
    holds their carried state across ticks); a :class:`DeviceRouter`
    keeps the per-device cycle ledger the :class:`CoScheduler` reports.
    Outputs equal the unmeshed path's — pad rows are zero rows of
    row-independent math, trimmed before anything reads them.  As in the
    JAX package, shards beyond the devices wrap round-robin: on one card
    ``mesh=4`` runs each wave as ONE call on the padded rows (the same
    launches as an unmeshed wave) while the router charges all four
    shards, and four sessions on four shards never stack, so a tick makes
    four core calls where an unmeshed tick makes one.  ``mesh=None`` (the
    default) is the unmeshed service; ``self.mesh`` and ``self.router``
    are then None, and a wave takes the same path over one slot on the
    service's device, where padding and trimming change nothing.
    """

    def __init__(self, batch_size: int = 8,
                 fuse: "FuseLevel | int" = FuseLevel.STREAM,
                 buckets: Optional[List[int]] = None,
                 bucketing: bool = True,
                 block_frames: int = 8,
                 backend="reference",
                 mesh: "SignalMesh | DataMesh | int | None" = None,
                 precision=None,
                 scheduler: "SigSched | dict | bool | None" = None,
                 device=DEFAULT_DEVICE):
        from ..signal.backends import HopperBackend, get_backend
        self.device = resolve_device(device)
        self.mesh = SignalMesh.coerce(mesh, device=self.device)
        if self.mesh is not None and any(
                d.type != self.device.type for d in self.mesh.devices):
            raise ValueError(f"mesh devices {self.mesh.devices} are not "
                             f"of the service's device type "
                             f"{self.device.type!r}")
        self.router = DeviceRouter(self.mesh.n_shards) \
            if self.mesh is not None else None
        # where a one-shot wave runs: the mesh, or one slot on the
        # service's own device — the same split/pad/trim path either way
        # (at one shard the pad and the trim change nothing)
        self._placement = self.mesh if self.mesh is not None else \
            SignalMesh(mesh=DataMesh([self.device]))
        self.batch_size = batch_size
        self.fuse = FuseLevel.coerce(fuse)
        self.backend = get_backend(backend)
        if precision is not None:
            # serve a calibrated program: rebuild the array backend with
            # the policy, part of its ``cache_key``.
            if not isinstance(self.backend, HopperBackend):
                raise ValueError(
                    f"SignalService(precision=...) needs the 'hopper' "
                    f"backend (got {self.backend.name!r}); only the "
                    f"array backend int-routes calibrated widths")
            self.backend = HopperBackend(precision=precision)
        self.precision = precision
        self.buckets = sorted(int(b) for b in buckets) if buckets else None
        self.bucketing = bucketing
        self.block_frames = int(block_frames)
        self._graphs: Dict[str, _Registration] = {}
        self._compiled: Dict[Tuple[str, int], CompiledSignalGraph] = {}
        self._sharded: Dict[Tuple[str, int], Callable] = {}
        self._cost_cache: Dict[Tuple[str, int], int] = {}
        self._fp_cache: Dict[Tuple[str, int], Optional[Tuple]] = {}
        self._queue: List[SignalRequest] = []
        self._seq = 0
        self._sessions: Dict[str, List["StreamSession"]] = {}
        self._sid = 0
        self._ckpt_seq = 0            # next save_checkpoint step number
        # est_cycles accumulates the perf-model cost of every executed
        # batch, one-shot and streaming (the co-scheduler reads deltas of
        # it).  wall_cycles is the sharded-aware latency clock: per
        # execution it advances by the MAX per-shard share (shards run
        # concurrently), so on a mesh it runs up to n_shards-fold slower
        # than est_cycles.  They coincide when mesh is None.
        self.est_cycles = 0
        self.wall_cycles = 0
        self.stats = {"compiles": 0, "batches": 0, "bucketed": 0,
                      "exact": 0, "dropped": 0, "detached_sessions": 0,
                      "core_calls": 0, "flush_core_calls": 0,
                      "stream_ticks": 0, "bucket_overflow": 0,
                      "param_splits": 0}
        # the dispatch brain: SigSched decides which wave runs each
        # step() tick (cross-graph batching, deadline-aware EDF,
        # preemptible row budgets).  Default configuration reduces to
        # the legacy FIFO pick when nothing carries a finite deadline.
        # ``scheduler=False`` disables it (the pure pre-SigSched loop);
        # a dict passes SigSched options; an instance is adopted.
        if scheduler is False:
            self.scheduler: Optional[SigSched] = None
        elif scheduler is None or scheduler is True:
            self.scheduler = SigSched(self)
        elif isinstance(scheduler, dict):
            self.scheduler = SigSched(self, **scheduler)
        else:
            scheduler.service = self
            self.scheduler = scheduler

    # -- registry -----------------------------------------------------------
    def register(self, name: str, graph: SignalGraph, params=None) -> None:
        """Register (or replace) a named graph.  Replacement drops the
        stale compile/cost caches, any queued requests referencing the
        old graph, AND detaches its open streaming sessions (their
        carried state was built under the old graph's frame/hop) — their
        ``error`` fields say why.  Nothing queued or streaming can ever
        execute against a graph it was not submitted for."""
        replacing = name in self._graphs
        try:
            struct = StreamStructure.analyze(graph)
        except ValueError:
            struct = None                     # offline-only: exact lengths
        self._graphs[name] = _Registration(graph, params, struct)
        for cache in (self._compiled, self._sharded, self._cost_cache,
                      self._fp_cache):
            for key in [k for k in cache
                        if k[0] in (name, f"{name}//core")]:
                del cache[key]
        if replacing:
            stale = [r for r in self._queue if r.graph == name]
            for r in stale:
                self._queue.remove(r)
            if self.scheduler is not None:
                # claimed split-wave rows live outside the queue
                stale += self.scheduler.drop_graph(name)
            for r in stale:
                r.error = (f"graph {name!r} was re-registered while the "
                           f"request was queued; resubmit")
            self.stats["dropped"] += len(stale)
            for sess in self._sessions.pop(name, []):
                sess.closed = True
                sess.error = (f"graph {name!r} was re-registered; the "
                              f"stream's carried state no longer applies "
                              f"— open a new session")
                self.stats["detached_sessions"] += 1

    def compiled_for(self, name: str, length: int) -> CompiledSignalGraph:
        key = (name, length)
        if key not in self._compiled:
            _t0 = obs.now() if obs.ENABLED else 0
            graph = self._graphs[name].graph
            self._compiled[key] = graph.compile(length, fuse=self.fuse,
                                                backend=self.backend,
                                                device=self.device)
            self.stats["compiles"] += 1
            if obs.ENABLED:
                self._record_lowering(name, length, self._compiled[key], _t0)
        return self._compiled[key]

    def _record_lowering(self, name: str, length: int, compiled,
                         t0_ns: int) -> None:
        """Trace one bucket compile and accumulate the backend's
        fused-vs-emulated route counts (``lowering_report``) into the
        metrics registry."""
        rep = compiled.lowering_report()
        m = obs.metrics()
        pre = f"backend.{rep['name']}"
        m.counter(f"{pre}.fabric_fused").inc(rep["fabric_passes"]["fused"])
        m.counter(f"{pre}.fabric_emulated").inc(
            rep["fabric_passes"]["emulated"])
        for route, n in rep["array_passes"].items():
            m.counter(f"{pre}.array_{route}").inc(n)
        obs.complete("SignalService", "compile", t0_ns, graph=name,
                     bucket=length, backend=self.backend.name,
                     fabric=rep["fabric_passes"], array=rep["array_passes"])

    # -- length bucketing ---------------------------------------------------
    def bucket_for(self, name: str, length: int) -> Optional[int]:
        """The compile length serving a request of ``length`` samples:
        the smallest admissible bucket >= length (and >= the graph's
        minimum input), found by ``bisect`` over the sorted pinned
        buckets.  None => exact-length execution (bucketing off, graph
        not maskable, or length above the largest pinned bucket — the
        overflow case counts in ``stats["bucket_overflow"]``)."""
        reg = self._graphs[name]
        if not self.bucketing or reg.struct is None:
            return None
        lo = max(length, reg.struct.min_length)
        if self.buckets is not None:
            i = bisect.bisect_left(self.buckets, lo)
            if i == len(self.buckets):
                self.stats["bucket_overflow"] += 1
                if obs.ENABLED:
                    obs.metrics().counter("service.bucket_overflow").inc()
                return None
            return self.buckets[i]
        b = 1
        while b < lo:
            b <<= 1
        return b

    def group_key(self, req: SignalRequest) -> Tuple[str, int]:
        """The request's (graph, compile-length) batch key — computed
        once at submit and cached on the request, with ``req._bucketed``
        alongside, so the execution path never re-asks ``bucket_for``
        (which would double-count overflow)."""
        key = getattr(req, "_group_key", None)
        if key is None:
            length = int(np.asarray(req.samples).shape[-1])
            bucket = self.bucket_for(req.graph, length)
            req._bucketed = bucket is not None
            key = (req.graph, bucket if bucket is not None else length)
            req._group_key = key
        return key

    def exec_fingerprint(self, name: str,
                         length: int) -> Optional[Tuple]:
        """The structural compile-cache key of ``name``'s program at
        ``length`` (:func:`repro_torch.signal.backends.program_cache_key`):
        what the scheduler's cross-graph batching groups by.  ``None``
        when the program cannot be fingerprinted (opaque lambda closure
        — such graphs batch per registry name).  Compiles the bucket on
        first use; cached until re-registration."""
        key = (name, length)
        if key not in self._fp_cache:
            from ..signal.backends import program_cache_key
            compiled = self.compiled_for(name, length)
            self._fp_cache[key] = program_cache_key(self.backend,
                                                    compiled.program)
        return self._fp_cache[key]

    # -- queue --------------------------------------------------------------
    def submit(self, req: SignalRequest) -> None:
        """Validate and enqueue.  ``samples`` must be a real-valued 1-D
        ``(T,)`` array (ints are coerced to float32) long enough for the
        graph's analysis frame — rejected here with a clear error rather
        than failing inside the batch."""
        if req.graph not in self._graphs:
            raise KeyError(f"unknown graph {req.graph!r}")
        reg = self._graphs[req.graph]
        arr = np.asarray(req.samples)
        if arr.ndim != 1:
            raise ValueError(
                f"SignalRequest.samples must be 1-D (T,); got shape "
                f"{arr.shape} for rid={req.rid}")
        if not (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.integer)):
            raise TypeError(
                f"SignalRequest.samples must be real-valued; got dtype "
                f"{arr.dtype} for rid={req.rid}")
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        min_len = reg.struct.min_length if reg.struct is not None else 1
        if arr.shape[-1] < min_len:
            raise ValueError(
                f"SignalRequest.samples too short for graph "
                f"{req.graph!r}: {arr.shape[-1]} < {min_len} samples "
                f"(the analysis frame) for rid={req.rid}")
        req.samples = arr
        req.seq = self._seq
        self._seq += 1
        req._group_key = None          # (re-)keyed by THIS service's buckets
        req._exec_key = None           # ditto for the scheduler's grouping
        req._promoted_length = None
        self.group_key(req)
        self._queue.append(req)
        if obs.ENABLED:
            req._admit_ns = obs.now()
            m = obs.metrics()
            m.counter("service.submitted").inc()
            m.gauge("service.queue_depth").set(len(self._queue))

    def pending(self) -> int:
        """Requests not yet completed: the live queue plus rows claimed
        into the scheduler's partially-executed split waves."""
        n = len(self._queue)
        if self.scheduler is not None:
            n += self.scheduler.backlog_rows()
        return n

    def pending_groups(self) -> List[GroupInfo]:
        """Summaries of the queued batch groups, in FIFO order of their
        oldest member (what a policy needs to pick a group)."""
        groups: Dict[Tuple[str, int], List[SignalRequest]] = {}
        for r in self._queue:
            groups.setdefault(self.group_key(r), []).append(r)
        out = [GroupInfo(key=k, count=len(rs),
                         oldest_seq=min(r.seq for r in rs),
                         earliest_deadline=min(r.deadline for r in rs))
               for k, rs in groups.items()]
        out.sort(key=lambda g: g.oldest_seq)
        return out

    def group_cost(self, key: Tuple[str, int], batch: int = 1) -> int:
        """Perf-model cycles for one batched execution of a group
        (compiles the bucket on first use; cached thereafter)."""
        from ..core.perf_model import step_cost_estimate
        if key not in self._cost_cache:
            self._cost_cache[key] = step_cost_estimate(
                self.compiled_for(*key))
        return self._cost_cache[key] * max(1, batch)

    def _charge_devices(self, per_item: int, batch: int) -> int:
        """Charge one wave's per-device cost split to the router ledger
        (:func:`repro_torch.core.perf_model.device_step_costs` — pad rows
        execute, so every shard pays ``ceil(batch/n)`` rows) and return
        the wave's wall-clock cycles: the max per-device share on a mesh,
        the plain total otherwise."""
        if self.router is None:
            return per_item * max(1, batch)
        from ..core.perf_model import device_step_costs
        costs = device_step_costs(per_item, batch, self.router.n_devices)
        for i, c in enumerate(costs):
            if c:
                self.router.charge(i, c)
        if obs.ENABLED:
            obs.tracer().counter(
                "device_occupancy",
                {f"d{i}": c
                 for i, c in enumerate(self.router.device_cycles)})
        return max(costs)

    # -- one-shot batched execution -----------------------------------------
    def _fifo_pick(self, queue: List[SignalRequest]) -> List[SignalRequest]:
        key = self.group_key(queue[0])
        wave = [r for r in queue if self.group_key(r) == key]
        return wave[: self.batch_size]

    def make_pick(self, key: Tuple[str, int],
                  order: str = "fifo") -> Callable:
        """A picker for :meth:`step` selecting ``key``'s group, in FIFO
        or earliest-deadline order."""
        def pick(queue: List[SignalRequest]) -> List[SignalRequest]:
            wave = [r for r in queue if self.group_key(r) == key]
            if order == "deadline":
                wave.sort(key=lambda r: (r.deadline, r.seq))
            return wave[: self.batch_size]
        return pick

    def step(self, pick: Optional[Callable] = None) -> Dict[int, object]:
        """Execute ONE batched graph call and return ``{rid: output}``.

        With no explicit ``pick``, the service's :class:`SigSched`
        decides the wave (cross-graph batching by program fingerprint,
        EDF with slack-aware deferral when finite deadlines are queued,
        preemptible row budgets) — with the default configuration and no
        deadlines anywhere this reduces exactly to the legacy pick: the
        oldest request's (graph, bucket) group in arrival order, up to
        ``batch_size``.  Passing ``pick`` (or ``scheduler=False`` at
        construction) bypasses the scheduler.  Admission is continuous —
        requests submitted after earlier steps join whichever wave their
        group forms next.  All requests in a wave share one compiled
        program; shorter requests are zero-padded to the bucket and
        masked, and their outputs trimmed back to their true lengths.
        Scheduling changes WHEN a request computes, never what it
        computes.  Outputs come back as numpy arrays (per-output dicts
        for multi-output graphs)."""
        if pick is None and self.scheduler is not None:
            return self.scheduler.dispatch()
        if not self._queue:
            return {}
        wave = (pick or self._fifo_pick)(list(self._queue))
        if not wave:
            return {}
        return self._execute_wave(wave, self.group_key(wave[0])[1])

    # -- wave execution (what SigSched dispatches into) ----------------------
    def _params_classes(self, wave) -> List[Tuple[object, List[int]]]:
        """Wave rows grouped by their graph's registered params —
        identity first, then exact tree equality, each params object
        compared once a wave (equality reads device leaves back to the
        host).  One class == every row can share a single params
        argument."""
        return _split_by_params(
            [(self._graphs[r.graph].params, i) for i, r in enumerate(wave)])

    @staticmethod
    def _stackable(classes) -> bool:
        """True when every params class shares one tree structure with
        matching leaf shapes/types — the JAX package's per-row ``vmap``
        precondition, under which every stage takes its rows' params
        (:meth:`CompiledSignalGraph.per_row`).  Other waves run one
        sub-call per params class, counted in
        ``stats["param_splits"]``."""
        rep = classes[0][0]
        td = tree_structure(rep)
        sig = [_leaf_sig(l) for l in tree_leaves(rep)]
        for p, _ in classes[1:]:
            if tree_structure(p) != td:
                return False
            if [_leaf_sig(l) for l in tree_leaves(p)] != sig:
                return False
        return True

    @torch.no_grad()
    def _execute_wave(self, wave: List[SignalRequest],
                      length: int) -> Dict[int, object]:
        """Pad, stack, execute and trim one wave at compile ``length``.

        This is the half of ``step`` below the pick — the scheduler
        dispatches into it (possibly with a wave mixing requests from
        different fingerprint-equal graphs, or a chunk of a split wave
        whose siblings already ran).  Requests still in the queue are
        claimed here; rows keep their own true lengths, so masks and
        trims are identical however the wave was formed.  Waves mixing
        rows whose registered params differ execute per-row-batched (one
        call whose params carry a row axis:
        :meth:`_run_per_row_params`) when the params stack, else split
        into one sub-call per params class (``stats["param_splits"]``).
        Serving never differentiates."""
        _t0 = obs.now() if obs.ENABLED else 0
        for r in wave:
            try:
                self._queue.remove(r)
            except ValueError:
                pass                   # claimed earlier into a split wave
        name = wave[0].graph
        reg = self._graphs[name]
        compiled = self.compiled_for(name, length)
        key = (name, length)
        lens = [int(r.samples.shape[-1]) for r in wave]
        padded = any(t != length for t in lens)
        bucketed = any(getattr(r, "_bucketed", False) for r in wave)
        masked = padded or (reg.struct is not None
                            and reg.struct.framer is not None
                            and bucketed)
        classes = self._params_classes(wave)
        if len(classes) > 1 and (self.mesh is not None
                                 or not self._stackable(classes)):
            # params trees that do not stack (or a mesh, whose per-slot
            # split the per-row call does not thread): one
            # sub-call per params class — the same batched lowering as
            # per-graph dispatch, so exact.
            self.stats["param_splits"] += len(classes) - 1
            results: Dict[int, object] = {}
            for _, idxs in classes:
                results.update(
                    self._execute_wave([wave[i] for i in idxs], length))
            return results

        # on a mesh the row count pads to a shard multiple so the rows
        # split evenly over the slots; pad rows are zeros (a valid,
        # row-independent input) and are trimmed before any result is
        # read.  The host batch goes to each slot's device in its block.
        rows = self._placement.padded_rows(len(wave))
        stack = np.zeros((rows, length), np.float32)
        for i, r in enumerate(wave):
            stack[i, : lens[i]] = r.samples
        batch = torch.as_tensor(stack)
        if obs.ENABLED:
            # pad waste: the fraction of the stacked (batch, bucket)
            # array that is zero padding past each row's true length.
            pad_waste = 1.0 - sum(lens) / float(len(wave) * length)
            obs.complete("SignalService", "bucket_fill", _t0,
                         graph=name, bucket=length, batch=len(wave),
                         pad_waste=round(pad_waste, 4))
            obs.metrics().histogram("service.pad_waste").record(pad_waste)
            _t1 = obs.now()
        else:
            _t1 = _t0

        if len(classes) > 1:
            out = self._run_per_row_params(compiled, reg, batch, lens, wave,
                                           masked)
        elif masked:
            out = self._run_masked(key, reg, batch, lens, classes[0][0])
        else:
            out = _to_host(self._sharded_for(key)(batch, classes[0][0]))
        out = trim_rows(out, len(wave))
        self.stats["bucketed" if masked else "exact"] += 1
        self.stats["batches"] += 1
        self.est_cycles += self.group_cost(key, batch=len(wave))
        self.wall_cycles += self._charge_devices(self.group_cost(key),
                                                 len(wave))
        results = {}
        for i, r in enumerate(wave):
            r.done = True
            results[r.rid] = self._request_result(
                compiled, self._graphs[r.graph], out, i, lens[i])
        if obs.ENABLED:
            obs.complete(f"graph/{name}", "core_call", _t1,
                         bucket=length, batch=len(wave), masked=masked,
                         graphs=sorted({r.graph for r in wave}))
            self._record_emits(compiled, wave)
        return results

    def _run_per_row_params(self, compiled, reg, batch, lens, wave,
                            masked):
        """Cross-graph wave whose member graphs registered DIFFERENT
        params: one call whose params carry a leading row axis
        (:meth:`CompiledSignalGraph.per_row`; the rows' params trees
        stacked leaf by leaf on the service's device, as the JAX package
        stacks them for its ``vmap``) — each row computes with its own
        graph's params, and each kernel launches once for the wave, with
        one operand a row where the params hold it."""
        dev = self.device
        pstack = tree_map(
            lambda *xs: torch.stack([_device_leaf(x, dev) for x in xs]),
            *[self._graphs[r.graph].params for r in wave])
        struct = reg.struct
        vf = None
        if masked and struct is not None and struct.framer is not None:
            vf = torch.as_tensor([struct.valid_frames(t) for t in lens],
                                 dtype=torch.int32, device=dev)
        return _to_host(compiled.per_row(batch.to(dev), pstack,
                                         valid_frames=vf))

    def _record_emits(self, compiled, wave) -> None:
        """Admission->emit latency per request, attributed per graph and
        (for multi-output SigPrograms) per output."""
        m = obs.metrics()
        m.gauge("service.queue_depth").set(len(self._queue))
        t_now = obs.now()
        outs = [compiled.output] if compiled.single \
            else list(compiled.outputs)
        for r in wave:
            t_adm = getattr(r, "_admit_ns", None)
            if t_adm is None:
                continue
            lat_us = (t_now - t_adm) / 1e3
            m.histogram(f"service.latency_us.{r.graph}").record(lat_us)
            if len(outs) > 1:
                for o in outs:
                    m.histogram(
                        f"service.latency_us.{r.graph}/{o}").record(lat_us)

    def _request_result(self, compiled, reg, out, i, true_len):
        """Row ``i``'s result, trimmed back to the request's true
        length.  Multi-output graphs yield the ordered per-output dict
        (the SigProgram contract), each output trimmed along its own
        leading suffix axis (frame rows for frames-domain outputs,
        samples otherwise)."""
        def trim(res, name):
            if reg.struct is None:
                return res
            cnt = reg.struct.out_count_for(name, true_len)
            rank = len(compiled.out_types[name].suffix)
            sl = [slice(None)] * res.ndim
            sl[res.ndim - rank] = slice(0, cnt)
            return res[tuple(sl)]
        if compiled.single:
            return trim(out[i], compiled.output)
        return {name: trim(out[name][i], name)
                for name in compiled.outputs}

    def _sharded_for(self, key: Tuple[str, int]) -> Callable:
        """The per-slot entry point of ``key`` 's compiled bucket
        (:meth:`CompiledSignalGraph.sharded_jit` over the placement: the
        mesh, or one slot on the service's device; cached, so each slot's
        params copy is made once)."""
        if key not in self._sharded:
            self._sharded[key] = self.compiled_for(*key).sharded_jit(
                self._placement.mesh)
        return self._sharded[key]

    def _run_masked(self, key, reg, batch, lens, params):
        """Masked/padded execution: valid-frame counts per row ride the
        call, so one compile serves every length mix in the bucket."""
        struct = reg.struct
        if struct.framer is None:
            # pure sample chain: causal stages never read past a row's
            # valid prefix, so padding needs no masking — only trimming.
            return _to_host(self._sharded_for(key)(batch, params))
        # meshed batches carry zero pad rows past the wave: 0 valid
        # frames masks every frame of a pad row (an all-zero result
        # nothing reads back).
        counts = [struct.valid_frames(t) for t in lens]
        counts += [0] * (batch.shape[0] - len(counts))
        vf = torch.as_tensor(counts, dtype=torch.int32)
        return _to_host(self._sharded_for(key)(batch, params,
                                               valid_frames=vf))

    def serve(self, requests: List[SignalRequest]) -> Dict[int, object]:
        """Drain a request list."""
        for r in requests:
            self.submit(r)
        results: Dict[int, object] = {}
        while self.pending():
            results.update(self.step())
        return results

    # -- per-connection streaming sessions ----------------------------------
    def open_stream(self, name: str,
                    block_frames: Optional[int] = None) -> "StreamSession":
        """Open a streaming connection over a registered graph.  The
        graph must stream (sample chain, or stft -> core -> istft);
        chunked submissions go through :meth:`StreamSession.feed` and
        same-graph sessions' ready blocks execute as ONE core call per
        :meth:`stream_step`."""
        reg = self._graphs.get(name)
        if reg is None:
            raise KeyError(f"unknown graph {name!r}")
        if reg.struct is None or (reg.struct.framer is not None
                                  and reg.struct.deframer is None):
            raise ValueError(f"graph {name!r} is not streamable")
        sess = StreamSession(self, name, self._sid,
                             block_frames or self.block_frames)
        if self.router is not None:
            # device affinity for life: the session's carried state
            # lands on this shard's device and stays there across ticks.
            sess.device_index = self.router.assign()
        self._sid += 1
        self._sessions.setdefault(name, []).append(sess)
        return sess

    def _session_device(self, sess: "StreamSession") -> torch.device:
        """The device holding ``sess`` 's carried state: its shard's on
        a mesh, the service's otherwise."""
        if self.mesh is not None and sess.device_index is not None:
            return self.mesh.device_for(sess.device_index)
        return self.device

    def stream_sessions(self, name: Optional[str] = None) -> int:
        if name is not None:
            return len(self._sessions.get(name, []))
        return sum(len(v) for v in self._sessions.values())

    def stream_pending(self) -> bool:
        """True if any open session has a full block ready to execute."""
        for name, sessions in self._sessions.items():
            struct = self._graphs[name].struct
            for s in sessions:
                if ready_spec(struct, s.state, s.block_frames,
                              final=False) is not None:
                    return True
        return False

    @torch.no_grad()
    def stream_step(self) -> int:
        """Advance all streaming sessions by at most one block each.
        Ready blocks of sessions with matching shapes stack into ONE core
        call — same-graph always, and ACROSS graphs when the scheduler's
        cross-graph batching is on and the graphs' streamed core programs
        fingerprint identically AND their registered params compare equal
        (the core call threads one shared params tree).  On a mesh a
        stacked call never mixes shards: the session's shard is part of
        the stacking key, so no carried state migrates to serve a batch.
        Deciding which
        are ready reads only host counters; each session then
        overlap-adds its own slice back into its carried state through
        its own graph's structure and params, and pushes what became
        final to its pending output (a device-to-host copy).  Returns the
        number of core calls issued (at most one a tick for lock-stepped
        sessions of one graph, or of fingerprint-equal graphs with equal
        params, on one shard).  Serving never differentiates: the
        sessions' carried state must hold no autograd history from tick
        to tick."""
        calls = 0
        _t0 = obs.now() if obs.ENABLED else 0
        # per-shard cost of THIS tick: shards run concurrently, so the
        # tick's wall-clock contribution is the max over shards.
        tick_costs: Dict[Optional[int], int] = {}
        cross = (self.scheduler is not None and self.scheduler.cross_graph
                 and len(self._sessions) > 1)
        groups: Dict[Tuple, List[Tuple[str, "StreamSession", object,
                                       torch.Tensor]]] = {}
        for name, sessions in self._sessions.items():
            struct = self._graphs[name].struct
            for sess in sessions:
                spec = ready_spec(struct, sess.state, sess.block_frames,
                                  final=False)
                if spec is None:
                    continue
                block = take_block(sess.state, spec)
                ident: Tuple = ("graph", name)
                if cross:
                    fp = self._stream_fp(name, spec.n_frames)
                    if fp is not None:
                        ident = ("fp", fp)
                gkey = (ident, spec.n_frames, tuple(block.shape),
                        block.dtype, sess.device_index)
                groups.setdefault(gkey, []).append((name, sess, spec,
                                                    block))
        for (_, n_frames, _, _, dev), members in groups.items():
            device = self._session_device(members[0][1])
            # params ride the stacked core call as ONE shared tree, so a
            # fingerprint group sub-partitions by params equality —
            # fp-equal graphs with different weights never mix.
            for sub in self._stream_params_split(members):
                rep_name = sub[0][0]
                reg = self._graphs[rep_name]
                gnames = sorted({n for n, *_ in sub})
                _tc = obs.now() if obs.ENABLED else 0
                stacked = torch.stack([b for *_, b in sub]).to(device)
                res = reg.struct.core_jit(n_frames, self.fuse, self.backend,
                                          device)(stacked, reg.params)
                calls += 1
                if len(gnames) > 1:
                    self.scheduler.stats["cross_graph_batches"] += 1
                    if obs.ENABLED:
                        obs.metrics().counter(
                            "sched.cross_graph_batches").inc()
                if obs.ENABLED:
                    obs.complete(f"graph/{rep_name}", "stream_core", _tc,
                                 n_frames=n_frames, width=len(sub),
                                 device=dev, graphs=gnames)
                    obs.metrics().histogram(
                        "service.stream_stack_width").record(len(sub))
                cost = sum(self._stream_cost(n, n_frames) for n, *_ in sub)
                self.est_cycles += cost
                tick_costs[dev] = tick_costs.get(dev, 0) + cost
                if self.router is not None and dev is not None:
                    self.router.charge(dev, cost)
                for i, (name, sess, spec, block) in enumerate(sub):
                    sreg = self._graphs[name]
                    sstruct = sreg.struct
                    # fp-equal programs share stage/output names (the
                    # digest pins them), so the representative's result
                    # keys are valid for every member's own structure.
                    if isinstance(res, dict):
                        frames = res[sstruct.deframer][i]
                        taps = {t: tap_rows(res[t][i], spec, block.ndim - 1)
                                for t in sstruct.frame_outputs}
                    else:
                        frames, taps = res[i], {}
                    st, piece = commit_frames(sstruct, sess.state, spec,
                                              frames, final=False)
                    st, out = finalize_piece(sstruct, st, piece, final=False,
                                             params=sreg.params)
                    sess.state = st
                    if sstruct.single:
                        sess._push_out(out)
                    else:
                        merged = dict(out) if isinstance(out, dict) else {}
                        merged.update(taps)
                        sess._push_outs(merged)
        if tick_costs:
            self.wall_cycles += max(tick_costs.values())
            if obs.ENABLED and self.router is not None:
                obs.tracer().counter(
                    "device_occupancy",
                    {f"d{i}": c
                     for i, c in enumerate(self.router.device_cycles)})
        self.stats["core_calls"] += calls
        self.stats["stream_ticks"] += 1
        if obs.ENABLED:
            obs.complete("Streaming", "stream_tick", _t0,
                         core_calls=calls,
                         sessions=self.stream_sessions())
        return calls

    def _stream_fp(self, name: str, n_frames: int) -> Optional[Tuple]:
        """Fingerprint-keyed cache key of ``name``'s streamed CORE
        program at ``n_frames`` — the stream-side analog of
        :meth:`exec_fingerprint` (``None`` when the core cannot be
        fingerprinted: such sessions stack per graph name).  Cached
        until re-registration (the ``//core`` rows purge with the cost
        cache)."""
        key = (f"{name}//core", n_frames)
        if key not in self._fp_cache:
            from ..signal.backends import program_cache_key
            struct = self._graphs[name].struct
            compiled = struct.core_graph(n_frames, self.fuse, self.backend,
                                         self.device)
            self._fp_cache[key] = program_cache_key(self.backend,
                                                    compiled.program)
        return self._fp_cache[key]

    def _stream_params_split(self, members):
        """Partition one stream stacking group by registered-params
        equality (identity fast-path first) — each partition shares one
        params tree, preserving per-member order."""
        return [sub for _, sub in _split_by_params(
            [(self._graphs[m[0]].params, m) for m in members])]

    def _stream_cost(self, name: str, n_frames: int) -> int:
        """Perf-model cycles for one session's core block (cached)."""
        from ..core.perf_model import step_cost_estimate
        key = (f"{name}//core", n_frames)
        if key not in self._cost_cache:
            struct = self._graphs[name].struct
            self._cost_cache[key] = step_cost_estimate(
                struct.core_graph(n_frames, self.fuse, self.backend,
                                  self.device))
        return self._cost_cache[key]

    def _close_stream(self, sess: "StreamSession") -> None:
        lst = self._sessions.get(sess.graph_name, [])
        if sess in lst:
            lst.remove(sess)
            if self.router is not None:
                self.router.release(sess.device_index)

    # -- checkpoint / restore (the fault-tolerance contract) ----------------
    def session_by_sid(self, sid: int) -> Optional["StreamSession"]:
        for sessions in self._sessions.values():
            for s in sessions:
                if s.sid == sid:
                    return s
        return None

    def checkpoint(self) -> Dict:
        """Host-side snapshot of every open streaming session (carried
        state, pending unread output, delivery counters, shard affinity)
        plus the service counters and the router's cycle ledger.  Plain
        numpy throughout — independent of the device, cheap enough to
        take per tick.  One-shot queue entries
        are NOT captured (they are client-owned request objects,
        resubmittable by contract); streaming state is what only the
        service can reconstruct.  Restoring rewinds the state; the
        client replays its inputs from the checkpoint on, and the
        resumed stream is bit-identical."""
        sessions = [s.snapshot() for ss in self._sessions.values()
                    for s in ss]
        return {"format": 1,
                "sid": self._sid,
                "sessions": sessions,
                "est_cycles": self.est_cycles,
                "wall_cycles": self.wall_cycles,
                "device_cycles": list(self.router.device_cycles)
                if self.router is not None else None}

    def restore(self, ckpt: Dict) -> None:
        """Restore the streaming side to a :meth:`checkpoint`.  Live
        session handles are restored IN PLACE (client code keeps its
        ``StreamSession`` objects); sessions opened after the
        checkpoint are detached with an explanatory ``error``; sessions
        homed on a since-dropped shard are re-homed by the router.  Delivery
        counters are merged, not rewound — data a client already
        ``read()`` is never emitted twice after the replay (exactly-once
        delivery; see :meth:`StreamSession._dedup`)."""
        live = {s.sid: s for ss in self._sessions.values() for s in ss}
        self._sessions = {}
        restored = set()
        for snap in ckpt["sessions"]:
            name = snap["graph"]
            if name not in self._graphs:
                raise KeyError(f"cannot restore session {snap['sid']}: "
                               f"graph {name!r} is not registered")
            sess = live.get(snap["sid"])
            if sess is None:
                sess = StreamSession(self, name, snap["sid"],
                                     snap["block_frames"])
            sess._load_snapshot(snap)
            self._sessions.setdefault(name, []).append(sess)
            restored.add(snap["sid"])
        for sid, sess in live.items():
            if sid not in restored and not sess.closed:
                sess.closed = True
                sess.error = ("service restored to a checkpoint taken "
                              "before this session was opened")
                self.stats["detached_sessions"] += 1
        self._sid = max(self._sid, int(ckpt["sid"]))
        self.est_cycles = ckpt.get("est_cycles", self.est_cycles)
        self.wall_cycles = ckpt.get("wall_cycles", self.wall_cycles)
        dc = ckpt.get("device_cycles")
        if self.router is not None and dc is not None \
                and len(dc) == self.router.n_devices:
            self.router.device_cycles = [int(c) for c in dc]

    def save_checkpoint(self, directory: str, step: Optional[int] = None,
                        keep: int = 3, blocking: bool = True) -> int:
        """Persist :meth:`checkpoint` to disk through
        :class:`repro_torch.checkpoint.Checkpointer` (atomic tmp+rename
        dirs, COMMIT markers, keep-N retention) so streams survive
        process death.  Snapshot dicts mix numpy arrays with strings /
        ints / ``StreamState`` counters, so the arrays are stored as
        manifest leaves and the surrounding structure rides the
        manifest's JSON ``meta`` sidecar.  Returns the step number
        written."""
        from ..checkpoint import Checkpointer
        snap = self.checkpoint()
        if step is None:
            step = self._ckpt_seq
        self._ckpt_seq = step + 1
        enc, leaves = _ckpt_encode(snap)
        t0 = obs.now() if obs.ENABLED else 0
        Checkpointer(directory, keep=keep).save(step, leaves,
                                                blocking=blocking,
                                                meta=enc)
        if obs.ENABLED:
            obs.complete("SignalService", "save_checkpoint", t0,
                         step=step, leaves=len(leaves),
                         sessions=len(snap["sessions"]))
        return step

    def restore_from_disk(self, directory: str,
                          step: Optional[int] = None) -> int:
        """Template-free restore of :meth:`save_checkpoint` (default:
        the latest committed step) — the process-death path: a fresh
        service with the same graphs registered rebuilds every session
        from disk, with the same exactly-once delivery merge as
        :meth:`restore`.  Returns the step restored."""
        from ..checkpoint import Checkpointer
        step, leaves, enc = Checkpointer(directory).restore(
            like=None, step=step, with_meta=True)
        if enc is None:
            raise ValueError(
                f"checkpoint step {step} in {directory!r} has no "
                f"structure sidecar; was it written by save_checkpoint?")
        self.restore(_ckpt_decode(enc, leaves))
        self._ckpt_seq = max(self._ckpt_seq, step + 1)
        return step

    def drop_device(self, index: int, carry_state: bool = True) -> None:
        """Simulated device loss: mark the shard dead in the router and
        re-home its sessions onto surviving shards (their carried state
        moves once, to the new shard's device — affinity then holds
        there).  ``carry_state=False`` re-homes the sessions without
        reading their state off the lost device, for a caller that
        restores them from a host checkpoint next
        (:class:`~repro_torch.runtime.StreamSupervisor`)."""
        if self.router is None:
            raise ValueError("drop_device needs a meshed service")
        self.router.drop(index)
        moved = 0
        for sessions in self._sessions.values():
            for sess in sessions:
                if sess.device_index == index:
                    self.router.release(index)
                    sess.device_index = self.router.assign()
                    if carry_state:
                        sess.state = restore_state(
                            snapshot_state(sess.state),
                            self._session_device(sess))
                    moved += 1
        self.stats["device_losses"] = self.stats.get("device_losses",
                                                     0) + 1
        if obs.ENABLED:
            obs.instant("SignalService", "device_loss", device=index,
                        sessions_moved=moved)


class StreamSession:
    """One streaming connection to a :class:`SignalService`.

    ``feed(chunk)`` pushes samples (numpy or a tensor) through the
    connection's sample-domain pre-chain into its ring buffer on the
    service's device; the framed core runs when the service batches
    ready blocks across sessions in :meth:`SignalService.stream_step`.
    ``read()`` pops the samples that became final, as numpy; ``close()``
    drains the remainder (including the overlap-add tail) and returns
    everything unread.  The concatenated ``read()``/``close()`` stream
    equals a private :class:`~repro_torch.signal.StreamingRunner`'s
    (they share one drain implementation; bit for bit where the core's
    arithmetic does not depend on the batch) and matches the graph's
    offline execution to float32 rounding.
    """

    def __init__(self, service: SignalService, name: str, sid: int,
                 block_frames: int):
        self.service = service
        self.graph_name = name
        self.sid = sid
        self.block_frames = int(block_frames)
        self.state = StreamState()
        self.closed = False
        self.error: Optional[str] = None      # set when force-detached
        self.device_index: Optional[int] = None   # shard affinity (mesh)
        self._out: List[np.ndarray] = []
        self._outs: Dict[str, List[np.ndarray]] = {}
        # exactly-once delivery counters, in absolute stream positions
        # along each output's frames/time axis: ``_pushed`` = data ever
        # produced into the pending lists, ``_delivered`` = data handed
        # to the client by read()/close().  A checkpoint restore rewinds
        # _pushed with the state; _delivered is connection memory and
        # survives, so replayed ticks re-produce — and _dedup drops —
        # exactly the already-delivered prefix.  Single-output sessions
        # use the key None.
        self._pushed: Dict[Optional[str], int] = {}
        self._delivered: Dict[Optional[str], int] = {}

    @property
    def _reg(self) -> _Registration:
        return self.service._graphs[self.graph_name]

    @property
    def single(self) -> bool:
        """True when the graph uses the deprecated single-output
        contract (``read``/``close`` return bare arrays)."""
        return self._reg.struct.single

    @torch.no_grad()
    def feed(self, chunk) -> None:
        """Push one chunk (last axis = time; chunk lengths may vary)."""
        if self.closed:
            raise ValueError(self.error or f"session {self.sid} is closed")
        self.state, out = push_chunk(self._reg.struct, self.state, chunk,
                                     self._reg.params,
                                     self.service._session_device(self))
        if isinstance(out, dict):        # multi-output: chain taps emit now
            self._push_outs(out)
        elif out is not None:            # pure sample chain: no latency
            self._push_out(out)

    def _dedup(self, key: Optional[str], arr: np.ndarray,
               axis: int) -> np.ndarray:
        """Exactly-once delivery filter: advance the pushed counter and
        drop the piece's already-delivered prefix.  A no-op on a live
        stream (delivered never exceeds pushed); after a checkpoint
        restore, replayed ticks re-produce data the client already
        read, and this is where it disappears."""
        n = int(arr.shape[axis])
        start = self._pushed.get(key, 0)
        self._pushed[key] = start + n
        skip = min(n, max(0, self._delivered.get(key, 0) - start))
        if skip:
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(skip, None)
            arr = arr[tuple(sl)]
        return arr

    def _push_out(self, out) -> None:
        arr = self._dedup(None, _host(out), -1)
        if arr.shape[-1]:
            self._out.append(arr)

    def _push_outs(self, outs: Dict) -> None:
        for name, piece in outs.items():
            arr = _host(piece)
            axis = self._frames_axis(name, arr)
            arr = self._dedup(name, arr, axis)
            if arr.shape[axis]:
                self._outs.setdefault(name, []).append(arr)

    def _frames_axis(self, name: str, arr: np.ndarray) -> int:
        """Concatenation axis for an output's pieces: the frames axis
        for frame taps (right after the connection's batch axes, whose
        rank the ring buffer knows), the time axis otherwise."""
        struct = self._reg.struct
        if name in struct.frame_outputs and self.state.buf is not None:
            return self.state.buf.ndim - 1
        return arr.ndim - 1

    def frames_ready(self) -> int:
        """Frames currently executable without more input (lookahead
        held back, as in non-final streaming)."""
        struct = self._reg.struct
        if struct.framer is None:
            return 0
        spec = ready_spec(struct, self.state, 10 ** 9, final=False)
        return 0 if spec is None else spec.count

    def read(self):
        """Pop the output data that became final so far, as numpy.
        Single-output sessions return the bare sample array; multi-output
        sessions return a dict of the outputs with new data (per-output
        pieces concatenated along their frames/time axis)."""
        if self.single:
            if not self._out:
                shape = (*self.state.batch_shape, 0) \
                    if self.state.buf is None \
                    else (*self.state.buf.shape[:-1], 0)
                return np.zeros(shape, np.float32)
            out = self._out[0] if len(self._out) == 1 else np.concatenate(
                self._out, axis=-1)
            self._out = []
            # everything pushed is now in the client's hands
            self._delivered[None] = self._pushed.get(None, 0)
            return out
        outs = {}
        for name, pieces in self._outs.items():
            axis = self._frames_axis(name, pieces[0])
            outs[name] = pieces[0] if len(pieces) == 1 \
                else np.concatenate(pieces, axis=axis)
            self._delivered[name] = self._pushed.get(name, 0)
        self._outs = {}
        return outs

    @torch.no_grad()
    def close(self):
        """Flush: run the remaining frames (per-session, the block
        batched to 1 — tails have irregular shapes), emit the
        overlap-add tail, detach from the service, and return everything
        unread."""
        if self.closed:
            return self.read()
        self.closed = True
        struct, reg = self._reg.struct, self._reg
        if struct.framer is not None:
            svc = self.service

            def run_core(block, n_frames):
                cost = svc._stream_cost(self.graph_name, n_frames)
                svc.est_cycles += cost
                svc.wall_cycles += cost
                if svc.router is not None \
                        and self.device_index is not None:
                    svc.router.charge(self.device_index, cost)
                svc.stats["flush_core_calls"] += 1
                res = struct.core_jit(n_frames, svc.fuse, svc.backend,
                                      svc._session_device(self))(
                    block[None], reg.params)
                if isinstance(res, dict):
                    return {k: v[0] for k, v in res.items()}
                return res[0]

            self.state, out = drain_state(struct, self.state,
                                          self.block_frames, run_core,
                                          final=True, params=reg.params)
            if isinstance(out, dict):
                self._push_outs(out)
            elif out is not None:
                self._push_out(out)
        self.service._close_stream(self)
        return self.read()

    # -- checkpoint / restore ------------------------------------------------
    def snapshot(self) -> Dict:
        """Plain-data (host numpy) snapshot of this connection: carried
        state, pending unread output, exactly-once delivery counters and
        shard affinity.  Deep copies throughout — the snapshot is valid
        after any amount of further streaming, and after losing the
        device the live state was homed on."""
        return {
            "sid": self.sid,
            "graph": self.graph_name,
            "block_frames": self.block_frames,
            "device_index": self.device_index,
            "closed": self.closed,
            "error": self.error,
            "state": snapshot_state(self.state),
            "pending": [np.array(a) for a in self._out],
            "pendings": {k: [np.array(a) for a in v]
                         for k, v in self._outs.items()},
            "pushed": dict(self._pushed),
            "delivered": dict(self._delivered),
        }

    def _load_snapshot(self, snap: Dict) -> None:
        """Restore this connection in place from :meth:`snapshot`.  The
        carried state lands back on the session's shard's device
        (re-homed first if that shard was dropped), or on the service's
        device when unmeshed.  Pending output is re-pushed through the
        exactly-once filter, and the delivery counter keeps the live
        handle's progress — a client that read past the checkpoint sees
        no duplicates when replay catches the stream back up."""
        svc = self.service
        self.block_frames = int(snap["block_frames"])
        self.closed = bool(snap["closed"])
        self.error = snap["error"]
        home = snap.get("device_index")
        if svc.router is not None and home is not None \
                and not svc.router.alive[home]:
            if self.device_index is not None and self.device_index != home \
                    and svc.router.alive[self.device_index]:
                home = self.device_index   # re-homed by drop_device already
            else:
                svc.router.release(home)
                home = svc.router.assign()
        self.device_index = home
        self.state = restore_state(snap["state"],
                                   device=svc._session_device(self))
        # delivery memory merges forward: a fresh process takes the
        # checkpoint's counters, a live handle keeps what its client
        # already consumed (the larger of the two).
        delivered = dict(snap["delivered"])
        for k, v in self._delivered.items():
            delivered[k] = max(delivered.get(k, 0), v)
        self._delivered = delivered
        # re-push the checkpoint's pending pieces through the filter:
        # rewind the pushed counters by their extents, then push in
        # order — already-delivered prefixes drop out in _dedup.
        self._pushed = dict(snap["pushed"])
        self._out, self._outs = [], {}
        pend = [np.asarray(a) for a in snap["pending"]]
        if pend:
            self._pushed[None] = self._pushed.get(None, 0) \
                - sum(a.shape[-1] for a in pend)
            for a in pend:
                self._push_out(a)
        for name, pieces in snap["pendings"].items():
            pieces = [np.asarray(a) for a in pieces]
            axes = [self._frames_axis(name, a) for a in pieces]
            self._pushed[name] = self._pushed.get(name, 0) \
                - sum(a.shape[ax] for a, ax in zip(pieces, axes))
            for a in pieces:
                self._push_outs({name: a})


# --------------------------------------------------------------------------
# LLM + DSP co-scheduling policies
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TickPlan:
    """What one CoScheduler tick should do, as decided by a policy."""
    run_llm: bool = True
    run_dsp: bool = True                       # one-shot DSP batch
    run_streams: Optional[bool] = None         # session block round
    admit: bool = False                        # mid-flight LLM admission
    dsp_key: Optional[Tuple[str, int]] = None  # group to run (None: FIFO)
    dsp_order: str = "fifo"                    # "fifo" | "deadline"
    dsp_sched: bool = False                    # prefer SigSched dispatch
    # dsp_sched=True: when the service carries a SigSched, let IT pick
    # the wave (cross-graph batching, bounded deferral, row budgets) —
    # dsp_key/dsp_order stay filled as the fallback for services built
    # with scheduler=False (and for tests driving make_pick directly).

    def __post_init__(self):
        if self.run_streams is None:           # default: ride with DSP
            self.run_streams = self.run_dsp


class SchedulePolicy:
    """Decides, each tick, which workload classes run and how the DSP
    wave is picked.  Implement :meth:`plan`; the scheduler exposes its
    queues / wave / occupancy counters for inspection."""

    name = "base"

    def plan(self, sched: "CoScheduler") -> TickPlan:
        raise NotImplementedError


class RoundRobinPolicy(SchedulePolicy):
    """Every tick runs one LLM decode step AND one DSP batch, with LLM
    waves admitted only between waves: the reference policy."""

    name = "round_robin"

    def plan(self, sched: "CoScheduler") -> TickPlan:
        return TickPlan(run_llm=True, run_dsp=True, admit=False)


class LatencyAwarePolicy(SchedulePolicy):
    """Earliest-deadline-first across both workload classes: each tick
    runs the single workload whose most urgent pending request has the
    earliest *finite* deadline.  On a deadline tie (typically ``inf`` ==
    ``inf`` — nobody declared an SLO) the tick degrades to round-robin,
    both sides running in arrival order, so deadline-less traffic can
    never be starved by the other class.  Streaming sessions carry no
    deadline; their ready blocks ride along on every non-DSP tick.  LLM
    newcomers join the active wave mid-flight when slots free up — on
    LLM ticks, since admission itself costs a (re-)prefill and a
    DSP-only tick must not spend the device on one."""

    name = "latency_aware"

    def plan(self, sched: "CoScheduler") -> TickPlan:
        groups = sched.signals.pending_groups()
        dsp_dl = min((g.earliest_deadline for g in groups),
                     default=math.inf)
        llm_dl = sched.llm_earliest_deadline()
        have_llm = sched.llm_pending()
        if not groups:
            # no one-shot DSP wave to race: LLM advances, and any ready
            # stream blocks ride along (streams carry no deadline — they
            # must neither starve nor starve the token side).
            return TickPlan(run_llm=True, run_dsp=False,
                            run_streams=sched.signals.stream_pending(),
                            admit=True)
        best = min(groups, key=lambda g: (g.earliest_deadline,
                                          g.oldest_seq))
        if not have_llm or dsp_dl < llm_dl:
            # admit=False: admission re-prefills, an LLM-side action a
            # DSP-only tick must not perform (tick() honors admit only
            # when run_llm is set, for the same reason).
            return TickPlan(run_llm=False, run_dsp=True, admit=False,
                            dsp_key=best.key, dsp_order="deadline",
                            dsp_sched=True)
        if llm_dl < dsp_dl:
            # streaming blocks still ride along: real-time connections
            # can never starve behind deadline-bearing token traffic.
            return TickPlan(run_llm=True, run_dsp=False, run_streams=True,
                            admit=True)
        # deadline tie: round-robin the tick so neither class starves.
        return TickPlan(run_llm=True, run_dsp=True, admit=True,
                        dsp_key=best.key, dsp_order="deadline",
                        dsp_sched=True)


class CostBalancedPolicy(SchedulePolicy):
    """Keep the occupancy split between DSP and decode near
    ``dsp_target`` (fraction of estimated array cycles spent on DSP),
    using :func:`repro_torch.core.perf_model.step_cost_estimate` for
    compiled graphs and ``ServingEngine.decode_step_cost`` for decode
    steps.  Each tick runs the side that is furthest below its target
    share — under skewed load this shifts the interleave instead of
    blindly alternating (the paper's §V utilization argument at serving
    scope)."""

    name = "cost_balanced"

    def __init__(self, dsp_target: float = 0.5):
        if not 0.0 < dsp_target < 1.0:
            raise ValueError("dsp_target must be in (0, 1)")
        self.dsp_target = float(dsp_target)

    def plan(self, sched: "CoScheduler") -> TickPlan:
        have_llm = sched.llm_pending()
        have_dsp = (sched.signals.pending() > 0
                    or sched.signals.stream_pending())
        if not (have_llm and have_dsp):
            return TickPlan(run_llm=have_llm, run_dsp=have_dsp, admit=True)
        total = sched.llm_cycles + sched.dsp_cycles
        dsp_share = sched.dsp_cycles / total if total else 0.0
        if dsp_share < self.dsp_target:
            # admit=False on DSP-only ticks: admission re-prefills (an
            # LLM-side cost this tick chose not to pay).
            return TickPlan(run_llm=False, run_dsp=True, admit=False)
        return TickPlan(run_llm=True, run_dsp=False, admit=True)


_POLICIES = {p.name: p for p in
             (RoundRobinPolicy, LatencyAwarePolicy, CostBalancedPolicy)}


def get_policy(policy: Union[str, SchedulePolicy]) -> SchedulePolicy:
    """Resolve a policy name ('round_robin' | 'latency_aware' |
    'cost_balanced') or pass an instance through."""
    if isinstance(policy, SchedulePolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown policy {policy!r}; choose from "
            f"{sorted(_POLICIES)} or pass a SchedulePolicy instance")


# --------------------------------------------------------------------------
# The co-scheduler
# --------------------------------------------------------------------------

class CoScheduler:
    """One step loop over two workload classes on the same device.

    Each :meth:`tick` asks the :class:`SchedulePolicy` for a
    :class:`TickPlan` and then runs (a) one LLM decode step for the
    active token wave and/or (b) one batched DSP execution plus one
    streaming-session block round — the serving analogue of the paper's
    DLA interleaving signal tasks with DNN layers instead of farming
    them out to a separate DSP chip.

    Occupancy accounting: ``llm_cycles`` / ``dsp_cycles`` accumulate the
    perf-model cost estimates of every step executed, which is what the
    ``cost_balanced`` policy steers.
    """

    def __init__(self, engine: ServingEngine, signals: SignalService,
                 policy: Union[str, SchedulePolicy] = "round_robin"):
        self.engine = engine
        self.signals = signals
        self.policy = get_policy(policy)
        self._llm_queue: List[Request] = []
        self._wave: Optional[DecodeWave] = None
        self.llm_results: Dict[int, List[int]] = {}
        self.dsp_results: Dict[int, np.ndarray] = {}
        self.ticks = 0
        self.llm_cycles = 0
        self.dsp_cycles = 0

    # -- submission ---------------------------------------------------------
    def submit_llm(self, req: Request) -> None:
        self._llm_queue.append(req)

    def submit_signal(self, req: SignalRequest) -> None:
        self.signals.submit(req)

    # -- introspection (used by policies) -----------------------------------
    def llm_pending(self) -> bool:
        return self._wave is not None or bool(self._llm_queue)

    def llm_earliest_deadline(self) -> float:
        dls = [r.deadline for r in self._llm_queue]
        if self._wave is not None:
            dls.extend(r.deadline for r in self._wave.reqs)
        return min(dls, default=math.inf)

    def occupancy(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "llm_cycles": self.llm_cycles,
            "dsp_cycles": self.dsp_cycles}
        total = self.llm_cycles + self.dsp_cycles
        out["dsp_share"] = self.dsp_cycles / total if total else 0.0
        if self.signals.router is not None:
            # per-device view of the DSP side: the mesh router's ledger
            # (offered cycles per shard, liveness)
            out["per_device"] = self.signals.router.occupancy()
        return out

    @property
    def idle(self) -> bool:
        return (self._wave is None and not self._llm_queue
                and not self.signals.pending()
                and not self.signals.stream_pending())

    # -- the step loop ------------------------------------------------------
    def _charge_prefill(self) -> None:
        """Prefill processes ``prefill_tokens`` positions for the whole
        batch — first-order, that is one decode-step cost per token."""
        self.llm_cycles += (self.engine.decode_step_cost(self._wave.size)
                            * max(1, self._wave.prefill_tokens))

    def tick(self) -> None:
        _t0 = obs.now() if obs.ENABLED else 0
        plan = self.policy.plan(self)

        # LLM side (gated by the plan — a DSP-only tick must not spend
        # the device on a prefill): start a wave between waves, or admit
        # newcomers into a running wave when the policy allows it.
        if plan.run_llm:
            if self._wave is None and self._llm_queue:
                wave = self._llm_queue[: self.engine.batch_size]
                self._llm_queue = self._llm_queue[self.engine.batch_size:]
                self._wave = DecodeWave(self.engine, wave)
                self._charge_prefill()
            elif (plan.admit and self._wave is not None and self._llm_queue
                  and self.engine.temperature <= 0.0):
                free = self._wave.free_slots()
                if free > 0:
                    newcomers = self._llm_queue[:free]
                    self._llm_queue = self._llm_queue[free:]
                    self.llm_results.update(self._wave.admit(newcomers))
                    self._charge_prefill()      # admission re-prefills
        if plan.run_llm and self._wave is not None:
            self._wave.step()
            self.llm_cycles += self.engine.decode_step_cost(self._wave.size)
            self.llm_results.update(self._wave.pop_done())
            if self._wave.done:
                self.llm_results.update(self._wave.results())
                self._wave = None

        # DSP side: one batched one-shot wave and/or one streaming block
        # round (streams can ride along on LLM ticks — latency_aware
        # keeps real-time connections from starving behind token work).
        before = self.signals.est_cycles
        if plan.run_dsp:
            pick = None
            if plan.dsp_key is not None and not (
                    plan.dsp_sched and self.signals.scheduler is not None):
                pick = self.signals.make_pick(plan.dsp_key, plan.dsp_order)
            self.dsp_results.update(self.signals.step(pick=pick))
        if plan.run_streams:
            self.signals.stream_step()
        self.dsp_cycles += self.signals.est_cycles - before
        self.ticks += 1
        if obs.ENABLED:
            self._record_tick(plan, _t0)

    def _record_tick(self, plan: TickPlan, t0_ns: int) -> None:
        """One tick's trace footprint: the tick span (with the policy's
        decisions), the DSP/LLM occupancy counter track, and per-backend
        plan-cache hit-rate tracks."""
        obs.complete("CoScheduler", "tick", t0_ns,
                     tick=self.ticks, policy=self.policy.name,
                     run_llm=plan.run_llm, run_dsp=plan.run_dsp,
                     run_streams=plan.run_streams, admit=plan.admit)
        occ = self.occupancy()
        tr = obs.tracer()
        tr.counter("occupancy", {"dsp_cycles": self.dsp_cycles,
                                 "llm_cycles": self.llm_cycles})
        tr.counter("dsp_share", {"share": occ["dsp_share"]})
        if "per_device" in occ:
            per = occ["per_device"]
            tr.counter("device_occupancy",
                       {f"d{i}": c
                        for i, c in enumerate(per["device_cycles"])})
        m = obs.metrics()
        m.gauge("sched.dsp_share").set(occ["dsp_share"])
        m.counter("sched.ticks").inc()
        from ..signal import plan_cache_info
        for label, b in plan_cache_info()["by_backend"].items():
            total = b["hits"] + b["misses"]
            tr.counter(f"plan_cache/{label}",
                       {"hit_rate": b["hits"] / total if total else 0.0})

    def run(self) -> Tuple[Dict[int, List[int]], Dict[int, np.ndarray]]:
        while not self.idle:
            self.tick()
        return self.llm_results, self.dsp_results
