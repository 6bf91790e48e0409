"""Sharding policy: parameter, batch and cache partition specs — the
port's counterpart of the JAX package's ``models/sharding.py``, as pure
host functions over the port's params trees.

Param specs are derived from leaf names (the innermost dict key: the
init functions use stable naming conventions) and shapes; an axis
assignment that does not divide the dimension drops to replication, so
one rule table serves every arch and every mesh.  ``fsdp=True`` (grok-1,
internvl2) additionally shards a replicated dimension over the data
axis.  :func:`zero1_spec` adds data sharding for optimizer moments.  A
spec is a :class:`P`, equal to the JAX package's ``PartitionSpec`` entry
by entry.

The serving mesh (:class:`~repro_torch.serving.signal_mesh.SignalMesh`)
and :meth:`~repro_torch.signal.graph.CompiledSignalGraph.sharded_jit`
split bucket batches into per-slot blocks by :func:`split_rows`, under
:func:`batch_spec` 's degrade-to-replicate rules, as training batches
are; :func:`row_sharding` binds that spec to a mesh.

On a :class:`torch.distributed.device_mesh.DeviceMesh` (one process a
mesh position, :func:`repro_torch.launch.mesh.make_test_mesh`) the specs
place tensors as DTensors — the counterpart of ``jax.device_put`` under
a ``NamedSharding``: :func:`to_placements` turns a spec into DTensor
placements, :func:`distribute_tree` places a tree by a spec tree, and
:func:`shard_activations` pins a residual stream's batch sharding once
:func:`set_activation_mesh` has registered the mesh.  The JAX package's
sharded step relies on the SPMD partitioner; the port relies on
DTensor's sharding propagation, run with plain tensors (positions,
masks) read as replicated
(``torch.distributed.tensor.experimental.implicit_replication``, which
the train step enters).  Where DTensor has no
sharding rule for an op on the layout it is given, the operand is
redistributed explicitly to ``Replicate`` on the offending dims by
:func:`replicate_dims` — what GSPMD's inserted all-gather does.  Its
callers:

- :func:`split_dim`, where a dim sharded over the model axis is viewed
  as two, the first with fewer entries than the axis has positions (the
  view has no sharding then, so that dim is gathered first): the
  attention block's q/k/v projections viewed as (heads, head_dim) in
  ``models/transformer.py`` (kv heads under GQA);
- :func:`embedding_lookup`, the token embedding of a sharded table in
  ``models/transformer.py``: DTensor's rules for a lookup in a
  vocab-sharded table fail (indexing's backward, ``index_put``, on torch
  2.11; ``F.embedding`` 's masked partial sum once redistributed), so
  each rank looks its tokens up in its own rows and the vocab shards'
  partial rows are summed by one all-reduce; the table's model dim is
  gathered first when fsdp shards it over the data axis, which the
  tokens' batch uses;
- ``transformer.unstack_groups``, where a cache leaf is sharded on its
  stacked group axis (:func:`cache_specs` shards the first dim equal to
  the batch, as the JAX package's do): DTensor does not unbind a
  sharded dim;
- :func:`on_local_heads`, which :func:`repro_torch.models.layers.attention`
  calls on DTensors, with or without autograd: DTensor's einsum has no
  sharding for attention's grouped-head products (it views a batch dim
  and a head dim sharded on two mesh axes as one), and the flash kernel
  reads plain tensors, so each rank attends over its own heads and rows
  (``to_local()``) where q, k and v split their heads alike over axes
  that divide the kv heads, and q, k and v are gathered on all but the
  batch dim otherwise (a decode step's cache sharded on the head dim
  keeps its blocks: each rank's partial scores are summed by one
  all-reduce).

Where DTensor has no sharding at all for an op, or a loop of small ops
would crawl as DTensor ops, the model runs that stretch on each rank's
own blocks, wrapped back afterwards (:class:`LocalBlocks`): the MoE
routing, capacity dispatch, combine and load-balance loss
(``models/moe.py``: ``scatter_add_``, and the dense decode path's gates),
the mLSTM and sLSTM cells with their gates and norms (``models/xlstm.py``:
``log_sigmoid``, 4 heads over a 16-way model axis, the sLSTM's
per-token loop) and the causal conv (``models/layers.py``: ``F.pad``
does not plan on torch 2.11).  :func:`grad_like` hands a view that merges
heads its gradient in its own layout (whisper-small's 12 heads over a
16-way model axis).

A prefill of sharded params makes its cache sharded by
:func:`cache_specs` (:func:`cache_full`), and a block's output is
placed like its input (:func:`placed_like`) before the residual add —
the all-reduce of a row-parallel product, which also keeps DTensor from
splitting the residual stream's sequence, whose strided shards its
redistribution planner searches for minutes on a (2, 16, 16) mesh.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor import full as dtensor_full
from torch.utils.weak import WeakIdKeyDictionary

from ..tree import tree_map

__all__ = ["P", "NamedSharding", "param_spec", "param_specs", "zero1_spec",
           "batch_axes", "batch_spec", "cache_spec", "cache_specs",
           "cache_full", "mesh_axes_of", "row_sharding", "split_rows",
           "to_placements", "distribute_tree", "set_activation_mesh",
           "shard_activations", "replicate_dims", "gathered_for_grad",
           "split_dim",
           "placed_like", "grad_like", "on_local_heads", "local_copies",
           "LocalBlocks", "embedding_lookup"]


class P(tuple):
    """A partition spec: one entry per dimension, each ``None``
    (replicated), a mesh axis name, or a tuple of axis names.  Compares
    equal to the JAX package's ``PartitionSpec`` of the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (``jax.sharding.NamedSharding`` 's
    ``mesh`` and ``spec``)."""
    mesh: object
    spec: P


# (regex on leaf key, (rule for each rank)) — rules are tuples of axis
# roles: "tp" = model axis, "dp" = fsdp candidate, None = replicated.
_RULES = [
    (r"^embed$",            ("tp", "dp")),
    (r"^head$",             ("dp", "tp")),
    (r"^(wq|wk|wv|xwq|xwk|xwv)$", ("dp", "tp")),
    (r"^(wo|xwo)$",         ("tp", "dp")),
    (r"^(w_gate|w_up)$",    ("dp", "tp")),
    (r"^w_down$",           ("tp", "dp")),
    (r"^router$",           (None, None)),
    (r"^experts_(gate|up)$", (None, "dp", "tp")),
    (r"^experts_down$",     (None, "tp", "dp")),
    (r"^shared_(gate|up)$", ("dp", "tp")),
    (r"^shared_down$",      ("tp", "dp")),
    (r"^shared_route$",     (None, None)),
    (r"^(rg_in|rg_gate_in)$", ("dp", "tp")),
    (r"^(rg_wa|rg_wx)$",    (None, "tp")),
    (r"^rg_lambda$",        ("tp",)),
    (r"^rg_out$",           ("tp", "dp")),
    (r"^conv_w$",           (None, "tp")),
    (r"^(m_up_x|m_up_z|m_wq|m_wk|m_wv)$", ("dp", "tp")),
    (r"^(m_wi|m_wf)$",      (None, None)),
    (r"^m_down$",           ("tp", "dp")),
    (r"^m_gn$",             ("tp",)),
    (r"^s_w[zifo]$",        ("dp", "tp")),
    (r"^s_r[zifo]$",        (None, None, None)),
    (r"^s_gn$",             (None,)),
    (r"^(s_up_gate|s_up)$", ("dp", "tp")),
    (r"^s_down$",           ("tp", "dp")),
    (r"^norm",              (None,)),
]


def _axis_fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's or an array's, ``()`` for a scalar."""
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def _map_named(fn, tree, name: str = ""):
    """``fn(leaf_name, leaf)`` over a params tree, keeping its
    structure; a leaf's name is its innermost dict key (list and tuple
    positions keep the enclosing one), ``""`` at the top."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, tree[k], str(k)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        children = [_map_named(fn, v, name) for v in tree]
        if hasattr(tree, "_fields"):             # a NamedTuple
            return type(tree)(*children)
        return type(tree)(children)
    return fn(name, tree)


def param_spec(name: str, shape: Tuple[int, ...], mesh_axes: Dict[str, int],
               fsdp: bool) -> P:
    """Resolve the partition spec of one parameter leaf."""
    tp = mesh_axes.get("model", 1)
    dp = mesh_axes.get("data", 1)
    for pat, roles in _RULES:
        if re.match(pat, name):
            # rank mismatch (stacked group leading dim): prepend None
            roles_ = roles
            extra = len(shape) - len(roles)
            if extra > 0:
                roles_ = (None,) * extra + tuple(roles)
            elif extra < 0:
                return P()
            out = []
            for dim, role in zip(shape, roles_):
                if role == "tp" and _axis_fits(dim, tp):
                    out.append("model")
                elif role == "dp" and fsdp and _axis_fits(dim, dp):
                    out.append("data")
                else:
                    out.append(None)
            return P(*out)
    return P()  # unknown -> replicate


def param_specs(params, mesh_axes: Dict[str, int], fsdp: bool):
    """Spec tree matching ``params`` (any leaves with a ``shape``)."""
    return _map_named(lambda name, leaf: param_spec(
        name, _shape(leaf), mesh_axes, fsdp), params)


def zero1_spec(spec: P, shape: Tuple[int, ...],
               mesh_axes: Dict[str, int]) -> P:
    """Add data-axis sharding to one replicated dim (optimizer moments).
    No-op when the param spec already consumes the data axis (fsdp)."""
    dp = mesh_axes.get("data", 1)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for p in parts if p is not None
            for a in ((p,) if isinstance(p, str) else tuple(p))}
    if "data" in used:
        return P(*parts)
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and _axis_fits(dim, dp):
            parts[i] = "data"
            break
    return P(*parts)


def batch_axes(mesh_axes: Dict[str, int]) -> Tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes)


def batch_spec(shape: Tuple[int, ...], mesh_axes: Dict[str, int],
               batch_dim: int = 0) -> P:
    """Shard the batch dim over (pod, data) when divisible; degrade to the
    largest divisible suffix of those axes; replicate a batch of 1."""
    parts: list = [None] * len(shape)
    axes = list(batch_axes(mesh_axes))
    while axes:
        total = math.prod(mesh_axes[a] for a in axes)
        if shape[batch_dim] % total == 0 and total > 1:
            parts[batch_dim] = tuple(axes) if len(axes) > 1 else axes[0]
            break
        axes = axes[1:]
    return P(*parts)


def cache_spec(shape: Tuple[int, ...], mesh_axes: Dict[str, int],
               batch: int) -> P:
    """One cache leaf's spec (:func:`cache_specs`)."""
    shape = tuple(shape)
    if not shape:
        return P()
    dp_axes = batch_axes(mesh_axes)
    dp = math.prod(mesh_axes[a] for a in dp_axes) if dp_axes else 1
    tp = mesh_axes.get("model", 1)
    parts: list = [None] * len(shape)
    batch_i = None
    for i, d in enumerate(shape):
        if d == batch and _axis_fits(d, dp):
            parts[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            batch_i = i
            break
    model_done = False
    if len(shape) >= 4 and len(shape) - 2 != batch_i \
            and _axis_fits(shape[-2], tp):
        parts[-2] = "model"
        model_done = True
    elif len(shape) >= 4 and _axis_fits(shape[-1], tp):
        # kv-heads don't divide the model axis (GQA): shard head_dim
        parts[-1] = "model"
        model_done = True
    if batch_i is None and not model_done and _axis_fits(shape[-1], tp):
        parts[-1] = "model"
    return P(*parts)


def cache_specs(cache, mesh_axes: Dict[str, int], batch: int):
    """KV caches / states: shard batch over the data axes when divisible,
    AND the kv-head dim (dim -2 of rank >= 4 attention caches) over model
    when divisible, else the head dim; falls back to sharding the
    trailing feature dim when neither applies."""
    return _map_named(lambda _, leaf: cache_spec(_shape(leaf), mesh_axes,
                                                 batch), cache)


def cache_full(shape: Tuple[int, ...], value: float, dtype, mesh,
               batch: int) -> torch.Tensor:
    """A cache leaf of ``shape`` filled with ``value``, made as a DTensor
    on ``mesh`` placed by :func:`cache_spec`: each rank allocates only
    its own block (a prefill of sharded params builds its cache so)."""
    spec = cache_spec(shape, mesh_axes_of(mesh), batch)
    return dtensor_full(tuple(shape), value, dtype=dtype, device_mesh=mesh,
                        placements=to_placements(spec, mesh))


def _axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh`` 's ``mesh_dim_names``, a
    :class:`~repro_torch.launch.mesh.DataMesh` 's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_axes_of(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a ``DataMesh``."""
    return dict(zip(_axis_names(mesh), tuple(mesh.shape)))


def row_sharding(mesh, shape: Tuple[int, ...],
                 batch_dim: int = 0) -> NamedSharding:
    """The sharding that splits ``shape`` 's batch axis over the mesh's
    (pod, data) axes by :func:`batch_spec` — replicated when the rows do
    not divide."""
    return NamedSharding(mesh, batch_spec(tuple(shape), mesh_axes_of(mesh),
                                          batch_dim))


def split_rows(mesh, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``x`` split along its leading (row) axis as a 1-D mesh computes it
    under :func:`batch_spec`: equal consecutive blocks in slot order,
    each on its slot's device, when the rows divide over the slots, else
    one block of all rows on the first slot (a replicated batch runs
    once).  Pads nothing itself."""
    rows = x.shape[0]
    if batch_spec((rows,), mesh_axes_of(mesh))[0] is None:
        return (x.to(mesh.devices[0]),)
    per = rows // len(mesh.devices)
    return tuple(x[i * per:(i + 1) * per].to(d)
                 for i, d in enumerate(mesh.devices))


# --------------------------------------------------------------------------
# Placement on a DeviceMesh (DTensor)
# --------------------------------------------------------------------------

def to_placements(spec, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``: one entry per mesh
    dim, ``Shard(i)`` where dim i of the tensor names that mesh axis,
    ``Replicate()`` elsewhere.  A tuple entry such as ``("pod", "data")``
    shards dim i over both axes, the first named the major one, as JAX
    lays it out; DTensor splits over mesh dims in mesh order, so the
    tuple must list its axes in that order."""
    names = _axis_names(mesh)
    out: List = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {names}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {names[j]!r} used twice in "
                                 f"{spec!r}")
            out[j] = Shard(i)
    return out


def distribute_tree(tree, specs, mesh):
    """``tree`` with every tensor leaf placed on ``mesh`` by the matching
    spec of ``specs`` (a tree of :class:`P`, or one spec for every leaf)
    — ``jax.device_put`` under ``NamedSharding`` s.  Every rank holds the
    same whole tree (drawn from one seed, or loaded alike, as the JAX
    package's single controller holds it) and keeps its own block of
    each leaf: nothing is sent.  A leaf of spec ``P()`` is replicated; a
    leaf that is not a tensor (an ``AdamWState`` 's step) stays as it
    is."""
    def place(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, to_placements(spec, mesh),
                                 src_data_rank=None)
    if isinstance(specs, P):
        return tree_map(lambda leaf: place(leaf, specs), tree)
    return tree_map(place, tree, specs)


def replicate_dims(x, dims) -> torch.Tensor:
    """``x`` with no mesh axis sharding any of ``dims`` (negative dims
    count from the end) and no partial sum pending: each such ``Shard``
    is redistributed to ``Replicate`` (an all-gather), each ``Partial``
    too (an all-reduce), other placements stay.  A plain tensor is
    returned as it is.  The module docstring lists the callers."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    pl = [Replicate() if isinstance(p, Partial) or (
        isinstance(p, Shard) and p.dim % x.ndim in dims) else p
        for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def gathered_for_grad(w, dims) -> torch.Tensor:
    """A weight as a product under autograd reads it: with ``dims``
    gathered (:func:`replicate_dims`), so each rank multiplies its own
    rows by whole columns of the weight, and the weight's gradient is a
    partial sum reduced once to its layout.  Where fsdp splits a
    weight's contracted dim over data (grok-1-314b's experts and head),
    DTensor otherwise plans a backward that depends on the torch
    version: torch 2.11 computes the down projection's and the head's
    gradients whole on every rank, torch 2.13 gathers the rows instead.
    Without a gradient (prefill, decode) ``w`` is returned as it is."""
    return replicate_dims(w, dims) if torch.is_grad_enabled() else w


def split_dim(x, dim: int, sizes: Tuple[int, ...]) -> torch.Tensor:
    """``x`` with dim ``dim`` viewed as ``sizes`` (their product its
    size).  A DTensor whose ``dim`` is sharded over mesh axes of a total
    size that does not divide ``sizes[0]`` has that dim gathered first
    (:func:`replicate_dims`): DTensor has no sharding for such a view."""
    dim %= x.ndim
    if isinstance(x, DTensor):
        ways = math.prod(x.device_mesh.size(j)
                         for j, p in enumerate(x.placements)
                         if isinstance(p, Shard) and p.dim % x.ndim == dim)
        if sizes[0] % ways:
            x = replicate_dims(x, [dim])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def placed_like(x, ref) -> torch.Tensor:
    """``x`` redistributed to ``ref`` 's placements when both are
    DTensors (a ``Partial`` of ``ref`` 's read as ``Replicate``: a
    pending sum is never recreated), else ``x``: an op's result goes
    back to its input's layout (:func:`on_local_heads`), a gradient to
    its param's (the train step)."""
    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)):
        return x
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in ref.placements)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(ref.device_mesh, pl)


class _GradLike(torch.autograd.Function):
    """The identity; its gradient redistributed to the layout the tensor
    had going forward."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        pl = tuple(Replicate() if isinstance(p, Partial) else p
                   for p in ctx.placements)
        if isinstance(grad, DTensor) and tuple(grad.placements) != pl:
            grad = grad.redistribute(ctx.mesh, pl)
        return grad


def grad_like(x) -> torch.Tensor:
    """``x``, whose gradient comes back in ``x`` 's own layout (a pending
    sum read as ``Replicate``): where ``x`` is a view that merges a dim
    DTensor cannot split again as it arrives — a merged (heads, head_dim)
    whose gradient comes split over more model ranks than the heads
    divide —, the view's backward then runs on that layout.  A plain
    tensor is returned as it is."""
    return _GradLike.apply(x) if isinstance(x, DTensor) else x


# the local blocks on_local_heads and LocalBlocks hand to plain code, by
# the number of ranks that hold each alike (its mesh axes that replicate
# them)
_LOCAL_COPIES = WeakIdKeyDictionary()


def local_copies(t: torch.Tensor, default=1):
    """How many ranks hold the local block ``t`` alike, when
    :func:`on_local_heads` or :class:`LocalBlocks` handed it to plain
    code; ``default`` for any other tensor.  ``launch/hlo_analysis.CostMode``
    reads it to tell the work other ranks repeat from a rank's own
    share."""
    return _LOCAL_COPIES.get(t, default)


def on_local_heads(fn, q, k, v) -> torch.Tensor:
    """``fn(q, k, v)`` — an attention on plain tensors, q (B, S, H, hd),
    k / v (B, S, KV, hd), its output shaped like q — on DTensors.  When
    q, k and v share their placements, none shards the sequence, every
    mesh axis that shards the heads divides KV (so a rank's query heads
    read only its own kv heads), and no partial sum is pending, each rank
    calls ``fn`` on its own blocks (``to_local()``); otherwise q, k and v
    are first gathered on all but the batch dim and their partial sums
    reduced (:func:`replicate_dims`).  Returns a DTensor laid out as
    ``q`` was.

    A cache sharded on the head dim (``cache_specs`` shards it where the
    kv heads do not divide the model axis) keeps its blocks: a q
    replicated where k and v shard the head dim takes its own block of
    it (nothing sent; a q split on its heads there is resplit on the
    head dim, and a pending sum of q's reduced onto k's layout: one
    collective of the step's queries), and ``fn`` gets
    ``score_reduce`` — the sum of the
    partial scores over those mesh axes, one all-reduce of the (B, H, Sq,
    Skv) scores — and ``head_dim``, the whole head dim for the scale.
    Its output block is gathered back to q's layout."""
    def head_dim_split(p):
        return isinstance(p, Shard) and p.dim % k.ndim == 3
    if (tuple(k.placements) == tuple(v.placements)
            and tuple(q.placements) != tuple(k.placements)
            and any(head_dim_split(pk) for pk in k.placements)
            and all(pq == pk or isinstance(pq, (Replicate, Partial)) or (
                head_dim_split(pk) and isinstance(pq, Shard)
                and pq.dim % q.ndim == 2)
                    for pq, pk in zip(q.placements, k.placements))):
        q0, q = q, q.redistribute(q.device_mesh, k.placements)
    else:
        q0 = q

    def local_ok():
        if not (tuple(q.placements) == tuple(k.placements)
                == tuple(v.placements)) or any(
                    isinstance(p, Partial) for p in q.placements):
            return False
        ways = 1
        for j, p in enumerate(q.placements):
            if isinstance(p, Shard):
                if p.dim % q.ndim not in (0, 2, 3):
                    return False
                if p.dim % q.ndim == 2:
                    ways *= q.device_mesh.size(j)
        return k.shape[2] % ways == 0
    if not local_ok():
        q, k, v = (replicate_dims(t, [1, 2, 3]) for t in (q, k, v))
        if not (tuple(q.placements) == tuple(k.placements)
                == tuple(v.placements)):
            q, k, v = (replicate_dims(t, [0, 1, 2, 3]) for t in (q, k, v))
    mesh = q.device_mesh
    hd_axes = [j for j, p in enumerate(q.placements)
               if isinstance(p, Shard) and p.dim % q.ndim == 3]
    extra = {}
    if hd_axes:
        from torch.distributed import _functional_collectives as funcol

        def score_reduce(scores):
            for j in hd_axes:
                scores = funcol.all_reduce(scores, "sum", mesh.get_group(j))
            return scores
        extra = {"score_reduce": score_reduce, "head_dim": q.shape[3]}
    # the DTensor is declared with q's shape and contiguous strides (q's
    # own may not be), so its local block is made contiguous: the plain
    # routes' einsum output may be a permuted view
    local = [t.to_local() for t in (q, k, v)]
    copies = math.prod(mesh.size(j) for j, p in enumerate(q.placements)
                       if isinstance(p, Replicate))
    for t in local:
        _LOCAL_COPIES[t] = copies
    out = fn(*local, **extra).contiguous()
    out = DTensor.from_local(out, q.device_mesh, q.placements,
                             run_check=False, shape=q.shape,
                             stride=torch.empty(q.shape,
                                                device="meta").stride())
    return placed_like(out, q0)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    return torch.empty(tuple(shape), device="meta").stride()


class LocalBlocks:
    """Each rank's own blocks around a stretch of plain-tensor code, for
    ops DTensor has no sharding for (the MoE dispatch's ``scatter_add_``,
    the xLSTM gates' ``log_sigmoid``) or that would be too slow as
    DTensor ops (the sLSTM's per-token loop).  ``ref`` is the stretch's
    input activation, batch first: the mesh axes that split its batch
    dim split the rows of every block; the other axes split ``heads``
    where they divide it (those of a tensor's ``head_dim``), and hold
    the blocks alike otherwise.

    - :meth:`local` — an activation's block in that layout
      (redistributed to it first: a pending sum reduced, a head dim
      gathered or split), registered with the ranks holding it alike
      (:func:`local_copies`);
    - :meth:`param` — a param's block, whole but for its heads; its
      gradient a partial sum over the row axes;
    - :meth:`rows` — a block of plain code's output wrapped back as a
      DTensor in that layout;
    - :meth:`mean` — a mean over dims that include the batch: the
      blocks' sums added over the row axes.

    A block whose batch dim is not its first (the MoE's expert-major slot
    buffer, ``(E, B, C, D)``) names it: ``local(t, row_dim=1)``,
    ``rows(t, row_dim=1)``.

    On plain tensors (``ref`` not a DTensor) every method returns its
    input unchanged (:meth:`mean` is ``t.mean(dims)``), so the
    unsharded path runs the same ops."""

    def __init__(self, ref, heads: int = 0):
        self.mesh = ref.device_mesh if isinstance(ref, DTensor) else None
        if self.mesh is None:
            return
        self.row_axes = [j for j, p in enumerate(ref.placements)
                         if isinstance(p, Shard) and p.dim % ref.ndim == 0]
        other = [j for j in range(self.mesh.ndim) if j not in self.row_axes]
        ways = math.prod(self.mesh.size(j) for j in other)
        split = heads > 0 and ways > 1 and heads % ways == 0
        self.head_axes = other if split else []

    def _layout(self, head_dim, rows: bool = True,
                row_dim: int = 0) -> List:
        out = []
        for j in range(self.mesh.ndim):
            if rows and j in self.row_axes:
                out.append(Shard(row_dim))
            elif j in self.head_axes and head_dim is not None:
                out.append(Shard(head_dim))
            else:
                out.append(Replicate())
        return out

    def local(self, t, head_dim=None, *, row_dim: int = 0) -> torch.Tensor:
        """``t`` 's block: rows (dim ``row_dim``) split as ``ref`` 's,
        the heads at ``head_dim`` split where the other axes divide them,
        gathered otherwise."""
        if self.mesh is None:
            return t
        pl = self._layout(head_dim, row_dim=row_dim)
        if list(t.placements) != pl:
            t = t.redistribute(self.mesh, pl)
        out = t.to_local()
        _LOCAL_COPIES[out] = math.prod(
            self.mesh.size(j) for j, p in enumerate(pl)
            if isinstance(p, Replicate))
        return out

    def param(self, p, head_dim=None) -> torch.Tensor:
        """A param's block: whole (gathered where sharded) but for its
        heads at ``head_dim``, split as :meth:`local` splits them.  Each
        rank's gradient of it is a partial sum over the row axes."""
        if self.mesh is None:
            return p
        pl = self._layout(head_dim, rows=False)
        if list(p.placements) != pl:
            p = p.redistribute(self.mesh, pl)
        return p.to_local(grad_placements=[
            Partial() if j in self.row_axes else pl[j]
            for j in range(self.mesh.ndim)])

    def rows(self, t, head_dim=None, *, row_dim: int = 0) -> torch.Tensor:
        """A block of plain code's output (its batch dim ``row_dim``) as
        a DTensor in the layout of :meth:`local`."""
        if self.mesh is None:
            return t
        pl = self._layout(head_dim, row_dim=row_dim)
        shape = list(t.shape)
        for j, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= self.mesh.size(j)
        return DTensor.from_local(t.contiguous(), self.mesh, pl,
                                  run_check=False, shape=tuple(shape),
                                  stride=_contiguous_stride(shape))

    def mean(self, t, dims: Tuple[int, ...]) -> torch.Tensor:
        """``t.mean(dims)`` over every rank's rows: on a block, its sum
        over ``dims`` (0, the batch, among them) added over the row axes
        (one all-reduce) and divided by the global count, replicated."""
        if self.mesh is None:
            return t.mean(dim=dims)
        if 0 not in [d % t.ndim for d in dims]:
            raise ValueError(f"LocalBlocks.mean over {dims}: the batch "
                             f"dim 0 must be among them")
        total = t.sum(dim=dims)
        count = math.prod(t.shape[d] for d in dims) * math.prod(
            self.mesh.size(j) for j in self.row_axes)
        total = DTensor.from_local(
            total, self.mesh, [Partial() if j in self.row_axes
                               else Replicate()
                               for j in range(self.mesh.ndim)],
            run_check=False, shape=tuple(total.shape),
            stride=_contiguous_stride(total.shape))
        return total.redistribute(self.mesh,
                                  [Replicate()] * self.mesh.ndim) / count


class _VocabLookup(torch.autograd.Function):
    """``table[tokens]`` on one rank's rows ``[v0, v0 + rows)`` of a
    vocab-sharded table, summed over the vocab shards' ``group`` (one
    rank holds each token's row, the others add zeros: exact).  The
    backward is each rank's: the output's gradient added into the rows
    its tokens read."""

    @staticmethod
    def forward(ctx, table, tokens, v0: int, group):
        idx = tokens - v0
        hit = (idx >= 0) & (idx < table.shape[0])
        idx = torch.where(hit, idx, torch.zeros_like(idx))
        out = torch.where(hit[..., None], table[idx],
                          torch.zeros((), dtype=table.dtype,
                                      device=table.device))
        if group is not None:
            dist.all_reduce(out, group=group)
        ctx.save_for_backward(idx, hit)
        ctx.rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad):
        idx, hit = ctx.saved_tensors
        out = torch.zeros((ctx.rows, grad.shape[-1]), dtype=grad.dtype,
                          device=grad.device)
        # a missed token adds an exact zero to row 0 (its idx): no
        # data-dependent shape, so the backward also runs on fake tensors
        d = grad.shape[-1]
        out.index_add_(0, idx.reshape(-1), torch.where(
            hit[..., None], grad, torch.zeros((), dtype=grad.dtype,
                                              device=grad.device))
            .reshape(-1, d))
        return out, None, None, None


def embedding_lookup(table, tokens) -> torch.Tensor:
    """``table[tokens]`` for a DTensor ``table`` (vocab, d) and token ids
    (a DTensor, or a plain tensor read as replicated), differentiable in
    ``table``.  The table's model dim is gathered first where it is
    sharded (:func:`replicate_dims`), as are the tokens over a mesh axis
    that shards the vocab; each rank then reads its own rows, and an
    all-reduce over the axis sharding the vocab sums the shards' partial
    rows.  The result is split over the mesh axes that split the
    tokens' batch; the table's gradient comes back in the table's
    layout, a partial sum over those axes."""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    table = replicate_dims(table, [1])
    vocab = [j for j, p in enumerate(table.placements)
             if isinstance(p, Shard)]
    if len(vocab) > 1:
        raise ValueError(f"embedding_lookup: the vocab is split over "
                         f"{len(vocab)} mesh axes; the rules split it over "
                         f"the model axis alone")
    tokens = replicate_dims(tokens, range(tokens.ndim)) if any(
        isinstance(tokens.placements[j], Shard) for j in vocab) else tokens
    grad_pl, out_pl = [], []
    for j, tp in enumerate(tokens.placements):
        split = isinstance(tp, Shard)
        grad_pl.append(Shard(0) if j in vocab else
                       Partial() if split else Replicate())
        out_pl.append(Shard(tp.dim) if split else Replicate())
    rows = table.to_local(grad_placements=grad_pl)
    v0 = mesh.get_coordinate()[vocab[0]] * rows.shape[0] if vocab else 0
    out = _VocabLookup.apply(rows, tokens.to_local(), v0,
                             mesh.get_group(vocab[0]) if vocab else None)
    shape = (*tokens.shape, table.shape[1])
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


# --------------------------------------------------------------------------
# Activation sharding constraints: with fsdp params the partitioner may
# replicate activations over the data axis instead of gathering params;
# the launcher registers the mesh and the models pin their residual
# streams explicitly (the JAX package's ``shard_activations``).
# --------------------------------------------------------------------------

_ACT_MESH = None


def set_activation_mesh(mesh) -> None:
    """Register the ``DeviceMesh`` :func:`shard_activations` pins to
    (``None`` clears it)."""
    global _ACT_MESH
    _ACT_MESH = mesh


def shard_activations(x, batch_dim: int = 0):
    """Redistribute a (B, S, D)-style DTensor so its batch dim is split
    over (pod, data) as :func:`batch_spec` gives it, every other dim
    replicated.  A no-op without a registered mesh, on a plain tensor,
    or when the batch does not divide."""
    if _ACT_MESH is None or not isinstance(x, DTensor):
        return x
    spec = batch_spec(tuple(x.shape), mesh_axes_of(_ACT_MESH), batch_dim)
    if all(p is None for p in spec):
        return x
    return x.redistribute(_ACT_MESH, to_placements(spec, _ACT_MESH))
