"""AdamW as plain functions on params trees of tensors (dicts, lists and
tuples of tensors): fp32 moments, global-norm clipping, cosine schedule
with linear warmup — the counterpart of the JAX package's
``optim/adamw.py``, with its defaults (b2 0.95, clip 1.0, decoupled decay
only on params with ``ndim >= 2``).  ``torch.optim.AdamW`` clips nothing
and decays every param, so it is not used.  Updates are functional, as
in the JAX package: ``adamw_update`` returns new tensors and leaves its
arguments as they were."""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "global_norm", "adamw_update",
           "cosine_schedule"]


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero float32 moments shaped like ``params``, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of every leaf of ``tree`` together."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2)
                          for leaf in tree_leaves(tree)))


def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step: returns ``(new_params, new_state, grad_norm)``.
    Gradients are clipped to global norm ``clip_norm`` first; the update
    runs in float32 and is cast back to each param's type."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step

    def upd(g, m, v, p):
        g32 = g.float() * scale
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32 * g32
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        # decoupled weight decay on matrix params only
        if p.ndim >= 2:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = [upd(*leaves) for leaves in zip(
        *(tree_leaves(t) for t in (grads, state.m, state.v, params)))]

    def rebuild(i):
        it = iter(o[i] for o in out)
        return tree_map(lambda _: next(it), params)
    return rebuild(0), AdamWState(step, rebuild(1), rebuild(2)), gnorm


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
