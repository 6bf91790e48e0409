"""Signal-graph serving: continuous-batched one-shot DSP requests.

The port's counterpart of the one-shot path of the JAX package's
``serving/signal_service.py``:

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

Results carry the SigProgram multi-output contract: graphs declared with
``outputs()``/``tap()`` return per-output dicts from :meth:`step` /
:meth:`serve`, each output trimmed back to the request's true length
along its own frames/time axis.

In this slice the service runs with ``scheduler=False`` (the FIFO pick:
the oldest request's ``(graph, bucket)`` group in arrival order, up to
``batch_size``), no mesh and no precision policy; streaming sessions,
SigSched, SigMesh, calibrated precision and the LLM co-scheduler are
later slices of the port.  With one graph and no deadlines SigSched's
pick equals the FIFO pick.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DEFAULT_DEVICE, resolve_device
from ..signal.graph import CompiledSignalGraph, FuseLevel, SignalGraph
from ..signal.streaming import StreamStructure

__all__ = ["SignalRequest", "SignalService", "GroupInfo"]


def _to_host(out):
    """Device results -> numpy, preserving the per-output dict of
    multi-output SigPrograms."""
    if isinstance(out, dict):
        return {k: v.detach().cpu().numpy() for k, v in out.items()}
    return out.detach().cpu().numpy()


@dataclasses.dataclass
class SignalRequest:
    rid: int
    graph: str
    samples: np.ndarray            # (T,) one channel of signal
    deadline: float = math.inf     # scheduler hint (later slices)
    done: bool = False
    error: Optional[str] = None    # set when the service drops the request
    seq: int = -1                  # arrival order (assigned by submit)


@dataclasses.dataclass
class _Registration:
    graph: SignalGraph
    params: object
    struct: Optional[StreamStructure]   # None => not bucketable


@dataclasses.dataclass(frozen=True)
class GroupInfo:
    """One pending batch group: requests sharing a (graph, length-bucket)
    compiled program."""
    key: Tuple[str, int]
    count: int
    oldest_seq: int
    earliest_deadline: float


def _unported(feature: str, item: str):
    raise NotImplementedError(
        f"SignalService({feature}) is not in this slice of the PyTorch "
        f"port (ROADMAP Queue 1 item {item})")


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
    (``"reference"`` plain torch, ``"hopper"`` the shuffle-GEMM CUDA
    kernels); ``device`` where it runs (``"cuda"`` by default, raising on
    a host without a card).

    ``scheduler`` must be False in this slice (the FIFO pick, which is
    SigSched's pick for one graph without deadlines), and ``mesh`` and
    ``precision`` None; anything else raises ``NotImplementedError``
    naming the ROADMAP item that brings it.
    """

    def __init__(self, batch_size: int = 8,
                 fuse: "FuseLevel | int" = FuseLevel.STREAM,
                 buckets: Optional[List[int]] = None,
                 bucketing: bool = True,
                 backend="reference",
                 mesh=None,
                 precision=None,
                 scheduler=False,
                 device=DEFAULT_DEVICE):
        from ..signal.backends import get_backend
        if scheduler is not False:
            _unported("scheduler=...", "3 (SigSched)")
        if mesh is not None:
            _unported("mesh=...", "6 (SigMesh)")
        if precision is not None:
            _unported("precision=...", "4 (bitserial_mm precision route)")
        self.batch_size = batch_size
        self.fuse = FuseLevel.coerce(fuse)
        self.backend = get_backend(backend)
        self.device = resolve_device(device)
        self.buckets = sorted(int(b) for b in buckets) if buckets else None
        self.bucketing = bucketing
        self._graphs: Dict[str, _Registration] = {}
        self._compiled: Dict[Tuple[str, int], CompiledSignalGraph] = {}
        self._cost_cache: Dict[Tuple[str, int], int] = {}
        self._queue: List[SignalRequest] = []
        self._seq = 0
        # est_cycles accumulates the perf-model cost of every executed
        # batch (the JAX package's co-scheduler reads deltas of it).
        self.est_cycles = 0
        self.stats = {"compiles": 0, "batches": 0, "bucketed": 0,
                      "exact": 0, "dropped": 0, "bucket_overflow": 0}

    # -- registry -----------------------------------------------------------
    def register(self, name: str, graph: SignalGraph, params=None) -> None:
        """Register (or replace) a named graph.  Replacement drops the
        stale compile/cost caches and any queued requests referencing the
        old graph — their ``error`` fields say why.  Nothing queued can
        ever execute against a graph it was not submitted for."""
        replacing = name in self._graphs
        try:
            struct = StreamStructure.analyze(graph)
        except ValueError:
            struct = None                     # offline-only: exact lengths
        self._graphs[name] = _Registration(graph, params, struct)
        for cache in (self._compiled, self._cost_cache):
            for key in [k for k in cache if k[0] == name]:
                del cache[key]
        if replacing:
            stale = [r for r in self._queue if r.graph == name]
            for r in stale:
                self._queue.remove(r)
                r.error = (f"graph {name!r} was re-registered while the "
                           f"request was queued; resubmit")
            self.stats["dropped"] += len(stale)

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
        self.group_key(req)
        self._queue.append(req)
        if obs.ENABLED:
            req._admit_ns = obs.now()
            m = obs.metrics()
            m.counter("service.submitted").inc()
            m.gauge("service.queue_depth").set(len(self._queue))

    def pending(self) -> int:
        """Requests not yet completed."""
        return len(self._queue)

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

        The wave is ``pick(queue)`` — by default the oldest request's
        (graph, bucket) group in arrival order, up to ``batch_size``.
        Admission is continuous — requests submitted after earlier steps
        join whichever wave their group forms next.  All requests in a
        wave share one compiled program; shorter requests are
        zero-padded to the bucket and masked, and their outputs trimmed
        back to their true lengths.  Outputs come back as numpy arrays
        (per-output dicts for multi-output graphs)."""
        if not self._queue:
            return {}
        wave = (pick or self._fifo_pick)(list(self._queue))
        if not wave:
            return {}
        return self._execute_wave(wave, self.group_key(wave[0])[1])

    def _execute_wave(self, wave: List[SignalRequest],
                      length: int) -> Dict[int, object]:
        """Pad, stack, execute and trim one wave at compile ``length``.
        Every row of a wave belongs to one registered graph (the pick
        groups by ``(graph, bucket)``), so one params argument serves
        the whole batch."""
        _t0 = obs.now() if obs.ENABLED else 0
        name = wave[0].graph
        if any(r.graph != name for r in wave):
            raise ValueError("a wave must hold requests of one graph")
        for r in wave:
            self._queue.remove(r)
        reg = self._graphs[name]
        compiled = self.compiled_for(name, length)
        key = (name, length)
        lens = [int(r.samples.shape[-1]) for r in wave]
        padded = any(t != length for t in lens)
        bucketed = any(getattr(r, "_bucketed", False) for r in wave)
        masked = padded or (reg.struct is not None
                            and reg.struct.framer is not None
                            and bucketed)
        stack = np.zeros((len(wave), length), np.float32)
        for i, r in enumerate(wave):
            stack[i, : lens[i]] = r.samples
        batch = torch.as_tensor(stack, device=self.device)
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

        with torch.no_grad():
            if masked:
                out = self._run_masked(compiled, reg, batch, lens)
            else:
                out = _to_host(compiled.jit()(batch, reg.params))
        self.stats["bucketed" if masked else "exact"] += 1
        self.stats["batches"] += 1
        self.est_cycles += self.group_cost(key, batch=len(wave))
        results = {}
        for i, r in enumerate(wave):
            r.done = True
            results[r.rid] = self._request_result(compiled, reg, out, i,
                                                  lens[i])
        if obs.ENABLED:
            obs.complete(f"graph/{name}", "core_call", _t1,
                         bucket=length, batch=len(wave), masked=masked)
            self._record_emits(compiled, wave)
        return results

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

    def _run_masked(self, compiled, reg, batch, lens):
        """Masked/padded execution: valid-frame counts per row ride the
        call, so one compile serves every length mix in the bucket."""
        struct = reg.struct
        if struct.framer is None:
            # pure sample chain: causal stages never read past a row's
            # valid prefix, so padding needs no masking — only trimming.
            return _to_host(compiled.jit()(batch, reg.params))
        vf = torch.as_tensor([struct.valid_frames(t) for t in lens],
                             dtype=torch.int32, device=self.device)
        return _to_host(compiled.masked_jit()(batch, vf, reg.params))

    def serve(self, requests: List[SignalRequest]) -> Dict[int, object]:
        """Drain a request list."""
        for r in requests:
            self.submit(r)
        results: Dict[int, object] = {}
        while self.pending():
            results.update(self.step())
        return results
