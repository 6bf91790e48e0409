"""GPipe-style pipeline parallelism over one dim of a ``DeviceMesh`` —
the port's counterpart of the JAX package's ``runtime/pipeline.py``,
whose ``shard_map`` body with ``lax.ppermute`` becomes one process a
stage exchanging activations by ``torch.distributed`` send / recv.

``spmd_pipeline(fn, stage_params, x, mesh=, axis_name=, n_microbatches=)``:

- each rank along ``axis_name`` holds ONE stage's params (the leading
  dim of ``stage_params`` 's leaves is the stage count: a plain tensor
  is indexed by the rank's stage, a DTensor sharded on that dim gives
  its local row);
- microbatches stream through the stages with the classic skewed
  schedule: tick t runs microbatch t - stage on ``stage``; after each
  tick a stage's output goes to stage + 1 (the JAX package's
  ``ppermute`` ring, whose last hop, back to stage 0, carries a value
  stage 0 never reads and is not sent here).  A stage computes only at
  the ticks that carry one of its microbatches, ``n_microbatches``
  calls of ``fn`` a stage: the JAX package's scan also computes the
  bubble's ticks and discards their results, which reach no output;
- the last stage collects the outputs and broadcasts them along the
  axis, so every rank returns them, as the JAX package's ``out[-1]``;
- total ticks = n_microbatches + n_stages - 1; the bubble fraction
  (S - 1) / (M + S - 1) is :func:`pipeline_bubble_fraction`.

Forward only: the exchange is not differentiated (the JAX package's
tests run it forward too).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..tree import tree_map

__all__ = ["pipeline_bubble_fraction", "spmd_pipeline"]


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _stage_slice(leaf, stage: int):
    if isinstance(leaf, DTensor):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a DTensor stage param holds {local.shape[0]} "
                             f"stages on this rank; shard its leading dim "
                             f"over the pipeline axis")
        return local[0]
    return leaf[stage]


def spmd_pipeline(fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                  axis_name: str, n_microbatches: int) -> torch.Tensor:
    """``x``: (n_microbatches, mb, ...), the same on every rank (stage 0
    reads it).  Returns ``fn`` applied by every stage in order to every
    microbatch, the same shape (``fn`` keeps its input's shape and
    type), on every rank.

    ``fn(params_for_stage, mb_input) -> mb_output`` is one stage's
    compute; ``mesh`` is a ``DeviceMesh`` with a dim named ``axis_name``
    of the stage count."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if x.shape[0] != n_microbatches:
        raise ValueError(f"x has {x.shape[0]} microbatches, expected "
                         f"{n_microbatches}")
    group = mesh.get_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    stage = mesh.get_local_rank(axis_name)
    params = tree_map(lambda leaf: _stage_slice(leaf, stage), stage_params)
    buf = torch.zeros_like(x[0])
    out = torch.zeros_like(x)

    def active(s, t):
        return 0 <= t - s < n_microbatches
    for t in range(n_microbatches + n_stages - 1):
        if active(stage, t):
            # stage 0 injects microbatch t, the others read what arrived
            y = fn(params, x[t] if stage == 0 else buf)
            if stage == n_stages - 1:
                out[t - stage] = y
        # shift to the next stage down the chain: receive before sending,
        # so no two ranks wait on each other
        if stage > 0 and active(stage - 1, t):
            dist.recv(buf, ranks[stage - 1], group=group)
        if stage < n_stages - 1 and active(stage, t):
            dist.send(y.contiguous(), ranks[stage + 1], group=group)
    dist.broadcast(out, ranks[n_stages - 1], group=group)
    return out
