"""Per-device cost of one traced step — the port's counterpart of the
JAX package's ``launch/hlo_analysis.py`` (the module keeps its name so a
reader finds the counterpart; there is no HLO here).

The JAX package re-derives FLOPs, HBM bytes and collective bytes from
XLA's optimized HLO text, multiplying each ``while`` body by the trip
count it recovers from the loop condition.  Eager PyTorch has neither:
the port's loops (pattern groups, microbatches, attention chunks) are
Python loops, so each iteration's ops reach the dispatcher one by one and
there is no trip count to recover — ``CostSummary.while_loops`` stays
``[]``.  :class:`CostMode`, a ``TorchDispatchMode``, counts at the
dispatcher instead, per op a rank runs:

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
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten, tree_map
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
    # no trip counts to recover in eager PyTorch (module docstring)
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
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


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


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, HBM bytes and collective bytes of the ops a rank
    runs inside it into :attr:`summary` (module docstring).  Every op it
    counts is also tallied by name in :attr:`op_counts`, and the FLOPs
    of each counted op in :attr:`op_flops`; the FLOPs beyond the rank's
    share (module docstring) in :attr:`replicated_flops`, by op in
    :attr:`op_replicated`."""

    def __init__(self):
        super().__init__()
        self.summary = CostSummary()
        self.op_counts: Dict[str, int] = {}
        self.op_flops: Dict[str, float] = {}
        self.replicated_flops = 0.0
        self.op_replicated: Dict[str, float] = {}
        # the shares of the DTensor ops whose local op has not run yet
        self._pending: List[Tuple[object, float]] = []
        # plain tensors derived from blocks several ranks hold alike
        self._copies = WeakIdKeyDictionary()
        # the local tensors of the DTensors the mode has seen an op of
        self._dtensor_locals = WeakIdKeyDictionary()
        self._iso: Optional[contextlib.ExitStack] = None

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
            if func.overloadpacket in _FLOP_OPS:
                flops, size = _global_flops(func, args, kwargs)
                self._pending.append((func.overloadpacket, flops / size))
            for t in _tensors((args, kwargs)):
                if isinstance(t, DTensor):
                    self._dtensor_locals[t._local_tensor] = True
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
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
                for t in _tensors(out):
                    self._copies[t] = copies
        self._count(func, args, kwargs, out, copies)
        return out

    def _count(self, func, args, kwargs, out, copies: int) -> None:
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        packet = func.overloadpacket
        share = None
        if packet in _FLOP_OPS and self._pending:
            want, share = self._pending.pop()
            if want is not packet:
                raise RuntimeError(f"DTensor's {want} ran a local {packet}")
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(t.device.type == "meta" for t in ins + outs):
            return
        s = self.summary
        key = f"{ns}.{name}"
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
            s.collective_bytes[kind] += nbytes
            s.collective_count += 1
            s.hbm_bytes += sum(tensor_bytes(t) for t in ins) + (
                0 if ns == "c10d" else nbytes)
            self.op_counts[key] = self.op_counts.get(key, 0) + 1
            return
        if packet in _FLOP_OPS:
            from torch.utils.flop_counter import flop_registry
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            s.flops += flops
            self.op_flops[key] = self.op_flops.get(key, 0) + flops
            extra = flops - (flops / copies if share is None else share)
            self.replicated_flops += extra
            self.op_replicated[key] = self.op_replicated.get(key, 0) + extra
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
        s.hbm_bytes += sum(tensor_bytes(t) for t in reads) + sum(
            tensor_bytes(t) for t in outs)
        self.op_counts[key] = self.op_counts.get(key, 0) + 1


def analyze(fn, *args, **kwargs) -> CostSummary:
    """The per-device :class:`CostSummary` of ``fn(*args, **kwargs)``,
    run once under a :class:`CostMode`."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.summary
