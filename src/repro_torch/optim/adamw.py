"""AdamW as plain functions on params trees of tensors (dicts, lists and
tuples of tensors): fp32 moments, global-norm clipping, cosine schedule
with linear warmup — the counterpart of the JAX package's
``optim/adamw.py``, with its defaults (b2 0.95, clip 1.0, decoupled decay
only on params with ``ndim >= 2``).  ``torch.optim.AdamW`` clips nothing
and decays every param, so it is not used.

``adamw_update`` is functional, as in the JAX package: it returns new
tensors and leaves its arguments as they were.  ``adamw_update_`` is the
train step's counterpart of the JAX package's donated buffers: the same
arithmetic, bit for bit, written into the given params and moments a
slice of rows at a time, so a full-width step holds one copy of its
state and one slice's float32 temporaries.

On a tree of DTensors (params placed on a ``DeviceMesh`` by
:func:`repro_torch.models.sharding.distribute_tree`) the moments take
their param's placements, :func:`global_norm` is the norm of the whole
tree — each rank's partial sum of squares over its own shards, one
reduction — and ``adamw_update_`` runs the same arithmetic on every
rank's local shards (``to_local()``).  Moments placed further than their
param (zero-1: :func:`repro_torch.models.sharding.zero1_spec` adds the
data axis, as the JAX package's dry-run places them) are updated on
each rank's block of the moments, and the param's new blocks are
gathered back to its own placements (one all-gather a leaf)."""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "global_norm", "adamw_update",
           "adamw_update_", "cosine_schedule"]


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero float32 moments shaped like ``params`` (a DTensor param's
    with its placements), step 0."""
    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def _sharded_norm(leaves) -> torch.Tensor:
    """The L2 norm of DTensor leaves on one mesh, as a plain 0-d tensor
    on every rank: each rank sums the squares of its local shards, a
    leaf replicated over a mesh dim counted only at coordinate 0 of that
    dim, and the partial sums are reduced once (a ``Partial`` 0-d
    DTensor made ``Replicate``)."""
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for leaf in leaves:
        if leaf.device_mesh != mesh:
            raise ValueError("global_norm: DTensor leaves on two meshes")
        if any(isinstance(p, Partial) for p in leaf.placements):
            raise ValueError("global_norm: a Partial leaf; redistribute it "
                             "to its param's placements first")
        if all(c == 0 or not isinstance(p, Replicate)
               for c, p in zip(coord, leaf.placements)):
            total = total + torch.sum(leaf.to_local().float() ** 2)
    part = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                              run_check=False)
    return torch.sqrt(part.full_tensor())


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of every leaf of ``tree`` together (of a tree
    of DTensors, the whole tree's: a plain 0-d tensor on every rank)."""
    leaves = tree_leaves(tree)
    if leaves and isinstance(leaves[0], DTensor):
        return _sharded_norm(leaves)
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2)
                          for leaf in leaves))


def _leaf_update(g, m, v, p, scale, lr, bc1, bc2, b1, b2, eps,
                 weight_decay, decay: bool):
    """One leaf's (or slice's) AdamW arithmetic -> (p, m, v) new; the
    decoupled decay applies when the whole param has ``ndim >= 2``."""
    g32 = g.float() * scale
    m_new = b1 * m + (1 - b1) * g32
    v_new = b2 * v + (1 - b2) * g32 * g32
    delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if decay:
        delta = delta + weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m_new, v_new


def _clip(grads, step: int, b1: float, b2: float, clip_norm: float):
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return gnorm, scale, 1 - b1 ** step, 1 - b2 ** step


def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step: returns ``(new_params, new_state, grad_norm)``.
    Gradients are clipped to global norm ``clip_norm`` first; the update
    runs in float32 and is cast back to each param's type."""
    step = state.step + 1
    gnorm, scale, bc1, bc2 = _clip(grads, step, b1, b2, clip_norm)
    out = [_leaf_update(g, m, v, p, scale, lr, bc1, bc2, b1, b2, eps,
                        weight_decay, p.ndim >= 2)
           for g, m, v, p in zip(*(tree_leaves(t) for t in (
               grads, state.m, state.v, params)))]

    def rebuild(i):
        it = iter(o[i] for o in out)
        return tree_map(lambda _: next(it), params)
    return rebuild(0), AdamWState(step, rebuild(1), rebuild(2)), gnorm


def _row_slices(t: torch.Tensor, chunk_elems: int) -> list:
    """Index slices along ``t``'s leading axis of at most ``chunk_elems``
    elements each (at least one row); the whole of a 0-d tensor."""
    if t.ndim == 0:
        return [...]
    row = max(t[0].numel(), 1)
    rows = max(1, chunk_elems // row)
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


@torch.no_grad()
def adamw_update_(grads, state: AdamWState, params, lr,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1, clip_norm: float = 1.0,
                  chunk_elems: int = 1 << 26):
    """:func:`adamw_update` in place: writes the new params into
    ``params``' tensors and the new moments into ``state.m`` / ``state.v``,
    and returns ``(params, AdamWState(step + 1, state.m, state.v),
    grad_norm)``, every value bit for bit :func:`adamw_update`'s.

    Each leaf is updated a slice of rows at a time, at most
    ``chunk_elems`` elements a slice (at least one row), so a stacked
    leaf goes through its leading group axis and no leaf needs more than
    one slice's float32 temporaries.  The global gradient norm is the
    functional update's (one reduction a leaf).  The step's arguments
    are changed as it goes: a failure part way leaves some leaves
    updated and others not.

    DTensor leaves are updated shard by shard on each rank (module
    docstring); the grads must have their params' placements, the
    moments their params' or the zero-1 ones."""
    step = state.step + 1
    gnorm, scale, bc1, bc2 = _clip(grads, step, b1, b2, clip_norm)
    for g, m, v, p in zip(*(tree_leaves(t) for t in (
            grads, state.m, state.v, params))):
        decay = p.ndim >= 2
        dest = None
        if isinstance(p, DTensor):
            # every rank updates its own shards; grads must be laid out as
            # their param is, moments as their param or zero-1
            if g.placements != p.placements or v.placements != m.placements:
                raise ValueError(f"adamw_update_: placements of the grad "
                                 f"{g.placements} and moments {m.placements}"
                                 f" / {v.placements} against the param's "
                                 f"{p.placements}")
            if m.placements != p.placements:
                # zero-1: this rank's block of the moments' layout (a local
                # chunk of the param and grad, nothing sent), its new param
                # block gathered back below
                dest, zpl = p, m.placements
                g, p = (t.redistribute(m.device_mesh, zpl) for t in (g, p))
                p = p.to_local().clone()
            else:
                p = p.to_local()
            g, m, v = (t.to_local() for t in (g, m, v))
        for sl in _row_slices(p, chunk_elems):
            p_new, m_new, v_new = _leaf_update(
                g[sl], m[sl], v[sl], p[sl], scale, lr, bc1, bc2, b1, b2,
                eps, weight_decay, decay)
            m[sl] = m_new
            v[sl] = v_new
            p[sl] = p_new
        if dest is not None:
            new = DTensor.from_local(p, dest.device_mesh, zpl,
                                     run_check=False, shape=dest.shape,
                                     stride=dest.stride())
            dest.to_local().copy_(new.redistribute(
                dest.device_mesh, dest.placements).to_local())
    return params, AdamWState(step, state.m, state.v), gnorm


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[int], float]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``."""
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * min(1.0, step / max(warmup, 1))
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return 0.5 * base_lr * (1 + math.cos(math.pi * frac))
    return lr
