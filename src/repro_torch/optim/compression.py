"""Int8 gradient compression with error feedback for the data-parallel
all-reduce — the port's counterpart of the JAX package's
``optim/compression.py``, the same arithmetic bit for bit.

``ef_compress_update`` quantizes (grad + residual) per tensor to int8,
keeps the quantization error as the next step's residual, and returns
the int8 payload and its scale.  ``allreduce_compressed`` is the
collective (int8 levels re-normalised to the largest scale, summed as
int32, dequantized) over a process group — the JAX package's
``axis_name`` inside ``shard_map``; a ``DeviceMesh`` dim's group is
``mesh.get_group("pod")``.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map

__all__ = ["compress_int8", "decompress_int8", "ef_init",
           "ef_compress_update", "allreduce_compressed"]


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``q`` int8 in [-127, 127], ``x ~ q * scale``, with
    ``scale = max(|x|, 1e-12) / 127`` a float32 0-d tensor."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(params) -> Any:
    """Zero float32 residuals shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress_update(grads, residuals):
    """``((q, scale) tree, new residuals)``: each leaf of ``grads`` plus
    its residual, quantized; the quantization error is the new
    residual."""
    pairs = []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        target = g.float() + r
        q, s = compress_int8(target)
        pairs.append(((q, s), target - decompress_int8(q, s)))
    it_p, it_r = iter(pairs), iter(pairs)
    payload = tree_map(lambda _: next(it_p)[0], grads)
    new_res = tree_map(lambda _: next(it_r)[1], grads)
    return payload, new_res


def allreduce_compressed(q: torch.Tensor, scale: torch.Tensor,
                         group=None) -> torch.Tensor:
    """The mean over ``group`` 's ranks (the default group when None) of
    their int8 payloads, as float32.  Each rank quantized under its own
    scale, so each re-normalises its levels to the largest scale (an
    all-reduce MAX) before the int32 sum (an all-reduce SUM: int8 ->
    int32 avoids overflow up to ~16M participants); the result is
    ``total * smax / n``."""
    smax = scale.detach().clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    q_norm = torch.round(q.float() * (scale / smax)).to(torch.int32)
    dist.all_reduce(q_norm, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return q_norm.float() * smax / float(n)
