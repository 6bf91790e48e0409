"""Per-device cost of one traced step — the port's counterpart of the
JAX package's ``launch/hlo_analysis.py`` (the module keeps its name so a
reader finds the counterpart; there is no HLO here).

The JAX package re-derives FLOPs, HBM bytes and collective bytes from
XLA's optimized HLO text, multiplying each ``while`` body by the trip
count it recovers from the loop condition.  Eager PyTorch has no HLO:
:class:`CostMode`, a ``TorchDispatchMode``, counts at the dispatcher
instead, per op a rank runs, and the port's scanned loops (pattern
groups, microbatches, the sLSTM's steps, the mLSTM's chunks, whisper's
layers, chunked attention's chunks) go through
:func:`repro_torch.loops.scan`, which hands them to the mode
(:meth:`CostMode.count_scan`, "Loops" below).  Per op:

- **FLOPs** of the ops the reference counts — dots and convolutions
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions; an einsum
  or a matmul reaches them) — and of the flash kernel's custom op
  ``repro_torch::flash_attention``, by ``torch.utils.flop_counter``'s
  formulas (the flash op's is
  :func:`repro_torch.kernels.flash_attention.ops.flash_flops`);
- **HBM bytes**, the eager counterpart of the reference's
  ``_instr_traffic``: each op reads its tensor operands and writes its
  results, a dim of stride 0 (an expanded operand) read once; views and
  metadata-only ops move nothing (the reference's ``_NO_TRAFFIC``); an
  in-place op writes only the tensor it is given, so an update of a slice
  writes the window, and ``copy_`` / ``fill_`` / ``zero_`` do not read
  the tensor they overwrite;
- **collective bytes**: each collective's result bytes, by the
  reference's kinds — the functional collectives DTensor issues
  (``_c10d_functional`` and its autograd twins) and the in-place
  ``c10d`` ops that ``torch.distributed`` calls dispatch
  (``dist.all_reduce``); ``recv`` stands for the send/recv pair of a
  ``collective-permute``.  The start op is counted, never
  ``wait_tensor``.

Per device, not global: a DTensor-level call is never counted — the mode
hands it back to DTensor (``NotImplemented``), which runs the local op on
the rank's shards, and that op comes back through the mode.  DTensor's
sharding propagation computes an op's output metadata by running the op
on global-shaped fake tensors; while a :class:`CostMode` is active that
propagation runs outside every dispatch mode (in a fake mode of its
own), so neither this mode nor a memory tracker below it sees those
global shapes.

Work other ranks repeat: :attr:`CostMode.replicated_flops` holds the
part of the rank's FLOPs beyond its share of the step's work.  A local
op that computes a DTensor op's result has as its share the op's FLOPs
on the global shapes over the mesh's size; an op on plain local tensors
(the blocks ``sharding.on_local_heads`` and ``sharding.LocalBlocks``
hand to plain code, and the ops derived from them, their backward
included) has its FLOPs over the number of ranks that hold its inputs
alike (:func:`repro_torch.models.sharding.local_copies`): the fewest
among the blocks it reads, a block's own registration first.  The count
does not pass through a DTensor op's local ops, whose placements say
who repeats them.  ``flops`` less
``replicated_flops`` is the rank's share, the count a roofline share
reads; the rest is work that ranks of a replicated mesh axis repeat, or
an uneven shard's surplus.

Loops.  A counted loop runs its body until two consecutive trips count
alike — in FLOPs, replicated FLOPs, HBM bytes and collective bytes by
kind; at least two trips, three where autograd records (a backward pass
through the loop reads a middle trip's backward) — and adds the last
trip's count once a skipped trip.  A loop whose trips never count alike
runs whole.  Each counted loop's ``(name, trips)`` is listed once in
:attr:`CostSummary.while_loops`; a loop of one trip, and a loop the
caller unrolls (``cfg.scan_layers`` False), is no loop (XLA inlines a
``while`` of one trip).  A backward pass through a counted loop runs
after the loop, on the trips that ran: each op of it is read from the
autograd node it runs for (``torch._C._current_autograd_node``), whose
sequence number tells the trip that made it, and the ops of the middle
trip's backward (the second-to-last trip run) count once for it and once
a skipped trip — a ``torch.utils.checkpoint`` recompute and the
gradients accumulated across trips included.  What a skipped trip would
have left behind is made, uncounted: its ``y`` (an uninitialized tensor
like the last), the gradient of each tensor of its ``x`` (a copy of the
last trip's, in its layout), and the bytes its trip kept alive for the
backward pass (the growth in live bytes over the last trip, read from
``live_bytes``), held until the backward pass reaches the loop — so a
memory tracker below the mode reads the whole loop's peak.

Two counts come out: :attr:`CostMode.summary`, the loop-aware one, and
:attr:`CostMode.naive`, trip-blind as XLA's own analysis — a counted
loop's body once (its last trip, and that trip's backward), as XLA
counts a ``while`` body.  ``CostMode(whole_loops=True)`` runs every loop
whole and lists none: both counts are then the count of every trip, the
comparison the loop-aware count is held to.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.weak import WeakIdKeyDictionary

# the import registers the flash kernel's op and its flop formula
from ..kernels.flash_attention import ops as _flash_ops  # noqa: F401
from ..models.sharding import local_copies

__all__ = ["COLLECTIVES", "CostSummary", "CostMode", "analyze",
           "tensor_bytes"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten

# ops whose FLOPs are counted (dots, convolutions, the flash kernel's op)
_FLOP_OPS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
             _aten.convolution, _aten._convolution, _aten.cudnn_convolution,
             _aten.convolution_backward,
             torch.ops.repro_torch.flash_attention)

# collective op names (namespaces _c10d_functional, _c10d_functional_autograd
# and c10d) -> the reference's kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# the send half of a send/recv pair, the waits and the autograd wrapper
# of a result: counted nowhere
_UNCOUNTED = {"send", "wait_tensor", "_wrap_tensor_autograd", "barrier",
              "monitored_barrier_"}

# ops that move no data (besides views, which every op marks itself)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "detach", "alias",
               "lift_fresh", "device", "sym_size", "sym_stride",
               "sym_numel", "sym_storage_offset", "is_same_size",
               "_local_scalar_dense", "set_", "resize_"}
# in-place ops that overwrite their destination without reading it
_OVERWRITE = {"copy_", "fill_", "zero_"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` 's elements, a dim of stride 0 counted once (an
    expanded operand is read once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return int(n) * t.element_size()


@dataclasses.dataclass
class CostSummary:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVES})
    collective_count: float = 0.0
    # the counted loops, (name, trips) once each (module docstring)
    while_loops: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_dict(self) -> dict:
        return {"flops": self.flops,
                "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_count": self.collective_count,
                "total_collective_bytes": self.total_collective_bytes,
                "while_loops": self.while_loops}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (nested tuples, lists
    and dicts), in order — a walk of its own: ``tree_flatten`` costs
    more than the op under a fake mode."""
    # a loop over a stack, not a recursive closure: that would be a
    # reference cycle holding the tensors until the cyclic collector
    # runs, which a memory tracker reads as live bytes
    out: List[torch.Tensor] = []
    todo = [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


# DTensor's own bookkeeping that computes on tensors of global shape or
# of index values: the output-metadata propagation (an op run on
# global-shaped fake tensors) and the block sizes of a strided shard (an
# index tensor read back with ``tolist``) — run outside every mode
_ISOLATED = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
)
# DTensor's plans that it caches in eager mode but recomputes on every
# call under a fake mode (which it takes for a compiler's trace with
# symbolic shapes): the sharding propagation of an op and the transform
# plan of a redistribution — memoized again while a CostMode is active,
# the shapes being static
_MEMOIZED = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "propagate_op_sharding_non_cached"),
    ("torch.distributed.tensor._redistribute", None,
     "_gen_transform_infos_non_cached"),
)


@contextlib.contextmanager
def _dtensor_bookkeeping():
    """Patch DTensor's bookkeeping (:data:`_ISOLATED`, :data:`_MEMOIZED`)
    for the life of the context: no mode counts it, a fake mode turns
    none of its index tensors fake (the propagation makes a fake mode of
    its own), and its plans are computed once per key, as in eager mode.
    A name the installed torch lacks raises: without its patch the
    counter would read global-shaped ops as the rank's."""
    import importlib
    patched = []

    def isolate(orig):
        @functools.wraps(orig)
        def isolated(*args, **kwargs):
            with _disable_current_modes():
                return orig(*args, **kwargs)
        return isolated

    def memoize(orig):
        memo = {}

        @functools.wraps(orig)
        def memoized(*args, **kwargs):
            key = (args, tuple(sorted(kwargs.items())))
            if key not in memo:
                memo[key] = orig(*args, **kwargs)
            return memo[key]
        return memoized

    try:
        for table, wrap in ((_ISOLATED, isolate), (_MEMOIZED, memoize)):
            for module, cls_name, name in table:
                owner = importlib.import_module(module)
                if cls_name is not None:
                    owner = getattr(owner, cls_name, None)
                orig = vars(owner).get(name) if owner is not None else None
                if orig is None:
                    raise RuntimeError(
                        f"torch {torch.__version__} has no "
                        f"{module}.{cls_name + '.' if cls_name else ''}"
                        f"{name}: CostMode cannot keep DTensor's "
                        f"bookkeeping out of its count")
                if isinstance(orig, staticmethod):
                    new = staticmethod(wrap(orig.__func__))
                else:
                    new = wrap(orig)
                setattr(owner, name, new)
                patched.append((owner, name, orig))
        yield
    finally:
        for owner, name, orig in reversed(patched):
            setattr(owner, name, orig)


def _global_flops(func, args, kwargs) -> Tuple[float, int]:
    """FLOPs of the DTensor op ``func`` on its operands' global shapes
    (run on ``meta`` tensors, outside every mode), and its mesh's size."""
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import flop_registry
    sizes = []

    def meta(x):
        if isinstance(x, DTensor):
            sizes.append(x.device_mesh.size())
        if isinstance(x, torch.Tensor):
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device="meta")
        return x
    with _disable_current_modes():
        margs, mkwargs = tree_map(meta, (args, kwargs))
        out = func(*margs, **mkwargs)
    return (flop_registry[func.overloadpacket](*margs, **mkwargs,
                                               out_val=out), sizes[0])


class _Tally:
    """One count: what :class:`CostSummary` holds, the replicated FLOPs,
    and the counts and FLOPs by op."""

    def __init__(self):
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = {op: 0.0 for op in COLLECTIVES}
        self.collective_count = 0
        self.replicated_flops = 0.0
        self.op_counts: Dict[str, int] = {}
        self.op_flops: Dict[str, float] = {}
        self.op_replicated: Dict[str, float] = {}

    def add(self, other: "_Tally", times: int = 1) -> None:
        """Add ``other`` 's count ``times`` times."""
        if not times:
            return
        self.flops += other.flops * times
        self.hbm_bytes += other.hbm_bytes * times
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] += v * times
        self.collective_count += other.collective_count * times
        self.replicated_flops += other.replicated_flops * times
        for mine, theirs in ((self.op_counts, other.op_counts),
                             (self.op_flops, other.op_flops),
                             (self.op_replicated, other.op_replicated)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v * times

    def alike(self, other: "_Tally") -> bool:
        """Whether two trips count alike (module docstring)."""
        return (self.flops == other.flops
                and self.replicated_flops == other.replicated_flops
                and self.hbm_bytes == other.hbm_bytes
                and self.collective_bytes == other.collective_bytes)

    def summary(self, while_loops) -> CostSummary:
        return CostSummary(self.flops, self.hbm_bytes,
                           dict(self.collective_bytes),
                           self.collective_count, list(while_loops))


class _Loop:
    """One run of a counted loop: the trips it ran and skipped, set when
    it ends."""

    def __init__(self):
        self.ran = self.skipped = 0
        self.done = False

    def weights(self, trip: int) -> Tuple[int, int]:
        """The loop-aware and trip-blind weights of a backward op made by
        ``trip`` of this ended loop (module docstring)."""
        middle = self.ran - 2 if self.skipped else -1
        return (1 + self.skipped if trip == middle else 1,
                1 if trip == self.ran - 1 else 0)


@dataclasses.dataclass
class _Span:
    """The autograd sequence numbers ``[start, end)`` of the nodes one
    trip of a loop made (``end`` None while it runs), inside ``parent``."""
    start: int
    loop: _Loop
    trip: int
    parent: Optional["_Span"]
    end: Optional[int] = None


class _Fan(torch.autograd.Function):
    """A trip's ``x`` tensors (views of them) for its body; their
    gradients pass through.  Its inputs also hold the later trips' ``x``
    tensors: if the trip is the middle one (the second-to-last the loop
    runs), the backward gives each skipped trip's tensors a copy of this
    trip's gradients, made uncounted — the gradients the skipped trips'
    backward would have made, in their layout."""

    @staticmethod
    def forward(ctx, mode, loop, trip, own, *tensors):
        ctx.set_materialize_grads(False)
        ctx.mode, ctx.loop, ctx.trip = mode, loop, trip
        ctx.later = len(tensors) - own
        return tuple(t.view_as(t) for t in tensors[:own])

    @staticmethod
    def backward(ctx, *grads):
        loop = ctx.loop
        later = [None] * ctx.later
        if loop.done and loop.skipped and ctx.trip == loop.ran - 2:
            # the middle trip's: the last trip run stands for the loop's
            # last, whose gradients may come back in other layouts
            with ctx.mode.uncounted():
                later[len(grads):] = [None if g is None else _copy(g)
                                      for _ in range(loop.skipped)
                                      for g in grads]
        return (None, None, None, None, *grads, *later)


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t``; of a DTensor, in its placements (pending sums
    kept: ``clone`` would reduce them)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t.clone()
    return DTensor.from_local(t.to_local().clone(), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=t.stride())


class _Hold(torch.autograd.Function):
    """Identity on a trip's carry, saving ``kept``, an empty tensor.  If
    the trip is the last the loop runs, its storage is grown to the bytes
    the skipped trips would have kept for the backward pass, alive until
    the backward pass has gone through the trip.  In a checkpointed
    region the first forward's ``kept`` goes to the checkpoint, and the
    recompute's, of the same shape (0,), takes its place."""

    @staticmethod
    def forward(ctx, kept, *tensors):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(kept)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


def _alike(y: Optional[torch.Tensor], n: int) -> list:
    """``n`` uninitialized tensors like ``y`` (None for None); a plain
    contiguous ``y`` 's are the rows of one allocation (one op, not
    ``n``: the sLSTM's skipped steps number thousands)."""
    from torch.distributed.tensor import DTensor
    if y is None:
        return [None] * n
    if y.is_contiguous() and not isinstance(y, DTensor):
        return list(y.new_empty((n,) + tuple(y.shape)).unbind(0))
    return [torch.empty_like(y) for _ in range(n)]


def _storage_bytes(tree) -> int:
    return sum(t.untyped_storage().nbytes() for t in _tensors(tree))


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, HBM bytes and collective bytes of the ops a rank
    runs inside it (module docstring): loop-aware into :attr:`summary`,
    trip-blind into :attr:`naive`.  Every op it counts is also tallied by
    name in :attr:`op_counts`, and the FLOPs of each counted op in
    :attr:`op_flops`; the FLOPs beyond the rank's share (module
    docstring) in :attr:`replicated_flops`, by op in
    :attr:`op_replicated` — all four loop-aware.

    ``whole_loops`` runs every counted loop whole, listing none.
    ``live_bytes``, a function returning the bytes live on the device
    now (a memory tracker's), sizes what a skipped trip keeps alive; with
    none, nothing is kept for it."""

    def __init__(self, whole_loops: bool = False,
                 live_bytes: Optional[Callable[[], int]] = None):
        super().__init__()
        # read by repro_torch.loops.scan: with whole_loops its loops run
        # as plain ones
        self.counts_loops = not whole_loops
        self._live_bytes = live_bytes
        # (loop-aware, trip-blind) counts: the step's, then one a trip of
        # each counted loop running
        self._frames: List[Tuple[_Tally, _Tally]] = [(_Tally(), _Tally())]
        self._while_loops: Dict[Tuple[str, int], None] = {}
        # the trips whose autograd nodes a backward op is read against,
        # by start; the trips running now
        self._spans: List[_Span] = []
        self._starts: List[int] = []
        self._open: List[_Span] = []
        self._uncounted = 0
        # the shares of the DTensor ops whose local op has not run yet
        self._pending: List[Tuple[object, float]] = []
        # plain tensors derived from blocks several ranks hold alike
        self._copies = WeakIdKeyDictionary()
        # the local tensors of the DTensors the mode has seen an op of
        self._dtensor_locals = WeakIdKeyDictionary()
        self._iso: Optional[contextlib.ExitStack] = None

    @property
    def summary(self) -> CostSummary:
        return self._frames[0][0].summary(self._while_loops)

    @property
    def naive(self) -> CostSummary:
        return self._frames[0][1].summary(self._while_loops)

    @property
    def op_counts(self) -> Dict[str, int]:
        return self._frames[0][0].op_counts

    @property
    def op_flops(self) -> Dict[str, float]:
        return self._frames[0][0].op_flops

    @property
    def replicated_flops(self) -> float:
        return self._frames[0][0].replicated_flops

    @property
    def op_replicated(self) -> Dict[str, float]:
        return self._frames[0][0].op_replicated

    @contextlib.contextmanager
    def uncounted(self):
        """Ops run inside reach the modes below (a memory tracker) but
        are not counted."""
        self._uncounted += 1
        try:
            yield
        finally:
            self._uncounted -= 1

    def __enter__(self):
        self._iso = contextlib.ExitStack()
        self._iso.enter_context(_dtensor_bookkeeping())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._iso.close()
            if self._pending and exc[0] is None:
                raise RuntimeError(f"DTensor ops ran no local op: "
                                   f"{self._pending}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._uncounted:
                return NotImplemented
            if func.overloadpacket in _FLOP_OPS:
                flops, size = _global_flops(func, args, kwargs)
                self._pending.append((func.overloadpacket, flops / size))
            for t in _tensors((args, kwargs)):
                if isinstance(t, DTensor):
                    self._dtensor_locals[t._local_tensor] = True
            return NotImplemented
        out = func(*args, **kwargs)
        if self._uncounted:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        # the copy count passes through plain code only (a DTensor op's
        # local op has the DTensor op's share): a block's registration
        # first, else the count of what it was computed from, the fewest
        # among the inputs
        copies = 1
        if not any(t in self._dtensor_locals for t in ins):
            marks = [m for m in (local_copies(t, None)
                                 or self._copies.get(t) for t in ins)
                     if m is not None]
            if marks:
                copies = min(marks)
                for t in outs:
                    self._copies[t] = copies
        self._count(func, args, kwargs, out, ins, outs, copies)
        return out

    def _weights(self) -> Tuple[int, int]:
        """The (loop-aware, trip-blind) weights of the op running now: 1
        outside a backward pass; in one, the product over the ended loops
        whose trips made the autograd node it runs for."""
        node = torch._C._current_autograd_node()
        if node is None or not self._spans:
            return 1, 1
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._starts, seq) - 1
        span = self._spans[i] if i >= 0 else None
        aware = naive = 1
        while span is not None:
            if span.loop.done and span.start <= seq < span.end:
                a, n = span.loop.weights(span.trip)
                aware, naive = aware * a, naive * n
            span = span.parent
        return aware, naive

    def _count(self, func, args, kwargs, out, ins, outs,
               copies: int) -> None:
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        packet = func.overloadpacket
        share = None
        if packet in _FLOP_OPS and self._pending:
            want, share = self._pending.pop()
            if want is not packet:
                raise RuntimeError(f"DTensor's {want} ran a local {packet}")
        # is_meta reads the tensor's keys; .device would dispatch an op
        # (prim.device) on a fake tensor
        if any(t.is_meta for t in ins + outs):
            return
        key = f"{ns}.{name}"
        flops = extra = 0
        kind, nbytes = None, 0
        if ns in _COLLECTIVE_NS:
            if name in _UNCOUNTED:
                return
            kind = _COLLECTIVE_KIND.get(name)
            if kind is None:
                raise ValueError(f"collective {key} has no kind among "
                                 f"{COLLECTIVES}")
            # c10d's in-place ops return (tensors, work): their first
            # argument holds the result
            res = _tensors(args[0]) if ns == "c10d" else outs
            nbytes = sum(tensor_bytes(t) for t in res)
            hbm = sum(tensor_bytes(t) for t in ins) + (
                0 if ns == "c10d" else nbytes)
        else:
            if packet in _FLOP_OPS:
                from torch.utils.flop_counter import flop_registry
                flops = flop_registry[packet](*args, **kwargs, out_val=out)
                extra = flops - (flops / copies if share is None else share)
            if func.is_view or name in _NO_TRAFFIC:
                return
            written = [i for i, a in enumerate(func._schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write]
            if written:
                dests = [args[i] if i < len(args)
                         else kwargs.get(func._schema.arguments[i].name)
                         for i in written]
                dests = _tensors(dests)
                ids = {id(t) for t in dests}
                reads = [t for t in ins
                         if not (name in _OVERWRITE and id(t) in ids)]
                outs = dests
            else:
                reads = ins
            hbm = sum(tensor_bytes(t) for t in reads) + sum(
                tensor_bytes(t) for t in outs)
        self._add(key, flops, extra, hbm, kind, nbytes)

    def _add(self, key: str, flops, extra, hbm, kind, nbytes) -> None:
        """Add one op's count, weighted, to the counts running now."""
        for tally, w in zip(self._frames[-1], self._weights()):
            if not w:
                continue
            if flops:
                tally.flops += flops * w
                tally.op_flops[key] = tally.op_flops.get(key, 0) + flops * w
                tally.replicated_flops += extra * w
                tally.op_replicated[key] = (tally.op_replicated.get(key, 0)
                                            + extra * w)
            tally.hbm_bytes += hbm * w
            if kind is not None:
                tally.collective_bytes[kind] += nbytes * w
                tally.collective_count += w
            tally.op_counts[key] = tally.op_counts.get(key, 0) + w

    # -- counted loops ------------------------------------------------------

    def count_scan(self, name: str, body, carry, xs: list):
        """:func:`repro_torch.loops.scan` under this mode (module
        docstring)."""
        loop = _Loop()
        grad = torch.is_grad_enabled()
        # a loop run again by a checkpoint's recompute, inside a backward
        # pass: its autograd nodes are never run, so none is read
        spans = grad and torch._C._current_autograd_node() is None
        least = 3 if grad else 2
        frames, ys, lives, stores = [], [], [self._live()], []
        parent = self._open[-1] if self._open else None
        try:
            for trip, x in enumerate(xs):
                frames.append((_Tally(), _Tally()))
                self._frames.append(frames[-1])
                span = None
                if spans:
                    span = _Span(torch.autograd._get_sequence_nr(), loop,
                                 trip, parent)
                    self._spans.append(span)
                    self._starts.append(span.start)
                    self._open.append(span)
                try:
                    # the trip's own nodes: a gradient they add up is
                    # the trip's
                    if spans:
                        x = self._fan(loop, trip, xs, x)
                    if grad:
                        # a recompute holds as the forward did: a
                        # checkpoint matches the tensors they save one
                        # for one
                        carry, store = self._hold(carry)
                        stores.append(store)
                    carry, y = body(carry, x)
                finally:
                    self._frames.pop()
                    if span is not None:
                        span.end = torch.autograd._get_sequence_nr()
                        self._open.pop()
                ys.append(y)
                lives.append(self._live())
                if (len(frames) >= least and trip + 1 < len(xs)
                        and frames[-1][0].alike(frames[-2][0])):
                    break
        except BaseException:
            # the trips' ops ran (a checkpoint's recompute may stop in a
            # trip once it has what the backward pass needs): count them
            for aware, naive in frames:
                self._frames[-1][0].add(aware)
                self._frames[-1][1].add(naive)
            raise
        loop.ran, loop.skipped = len(frames), len(xs) - len(frames)
        loop.done = True
        aware, naive = self._frames[-1]
        for a, _ in frames:
            aware.add(a)
        aware.add(frames[-1][0], loop.skipped)
        naive.add(frames[-1][1])
        self._while_loops[(name, len(xs))] = None
        if not loop.skipped:
            return carry, ys
        with self.uncounted():
            ys += _alike(ys[-1], loop.skipped)
        if grad:
            self._keep(stores[-1], lives, ys[loop.ran - 1], loop.skipped)
        return carry, ys

    def _live(self) -> Optional[int]:
        return None if self._live_bytes is None else self._live_bytes()

    def _fan(self, loop: _Loop, trip: int, xs: list, x):
        """``x`` with each tensor that requires grad through a
        :class:`_Fan`, which also holds the same tensors of every later
        trip."""
        leaves, spec = tree_flatten(x)
        at = [i for i, t in enumerate(leaves)
              if isinstance(t, torch.Tensor) and t.requires_grad]
        if not at:
            return x
        later = []
        for xl in xs[trip + 1:]:
            ll = tree_flatten(xl)[0]
            later += [ll[i] for i in at]
        views = _Fan.apply(self, loop, trip, len(at),
                           *(leaves[i] for i in at), *later)
        for i, v in zip(at, views):
            leaves[i] = v
        return tree_unflatten(leaves, spec)

    def _hold(self, carry):
        """``carry`` with its tensors that require grad through a
        :class:`_Hold`, and the hold's store (None if none requires
        grad)."""
        leaves, spec = tree_flatten(carry)
        at = [i for i, t in enumerate(leaves)
              if isinstance(t, torch.Tensor) and t.requires_grad]
        if not at:
            return carry, None
        t0 = leaves[at[0]]
        dev = (t0.to_local() if hasattr(t0, "to_local") else t0).device
        with self.uncounted():
            store = torch.empty(0, dtype=torch.uint8, device=dev)
        held = _Hold.apply(store, *(leaves[i] for i in at))
        for i, v in zip(at, held):
            leaves[i] = v
        return tree_unflatten(leaves, spec), store

    def _keep(self, store, lives, y, skipped: int) -> None:
        """Grow the last trip's hold ``store`` to the bytes the skipped
        trips would have kept alive for the backward pass: the largest
        growth in live bytes over a trip after the first (which also
        frees what came before the loop) less its ``y`` (the skipped
        trips' ``y`` are made), times ``skipped``.  Not in a checkpoint's
        first forward, which saves nothing (its recompute, inside the
        backward pass, grows the store it saves in its place)."""
        if store is None or lives[-1] is None:
            return
        if torch._C._current_autograd_node() is None and \
                torch._C._autograd._top_saved_tensors_default_hooks(
                    False) is not None:
            return
        grew = max(b - a for a, b in zip(lives[1:], lives[2:]))
        kept = max(grew - _storage_bytes(y), 0) * skipped
        if kept:
            store.untyped_storage().resize_(kept)


def analyze(fn, *args, **kwargs) -> CostSummary:
    """The per-device :class:`CostSummary` of ``fn(*args, **kwargs)``,
    run once under a loop-aware :class:`CostMode`."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.summary
