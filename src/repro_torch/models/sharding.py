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
are; :func:`row_sharding` binds that spec to a mesh.  Placing parameters
and activations by these specs (DTensor) waits for the multi-device
models (ROADMAP Queue 1 item 6e).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Tuple

import torch

__all__ = ["P", "NamedSharding", "param_spec", "param_specs", "zero1_spec",
           "batch_axes", "batch_spec", "cache_specs", "mesh_axes_of",
           "row_sharding", "split_rows"]


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


def cache_specs(cache, mesh_axes: Dict[str, int], batch: int):
    """KV caches / states: shard batch over the data axes when divisible,
    AND the kv-head dim (dim -2 of rank >= 4 attention caches) over model
    when divisible, else the head dim; falls back to sharding the
    trailing feature dim when neither applies."""
    dp_axes = batch_axes(mesh_axes)
    dp = math.prod(mesh_axes[a] for a in dp_axes) if dp_axes else 1
    tp = mesh_axes.get("model", 1)

    def f(_, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
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

    return _map_named(f, cache)


def mesh_axes_of(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


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
