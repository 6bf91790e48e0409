"""Train-step factory: gradients of the model's loss, microbatch gradient
accumulation and an in-place AdamW step — the port's counterpart of the
JAX package's ``launch/train.py``, driven by
:class:`repro_torch.runtime.TrainLoop`.

The JAX package jits the step with ``donate_argnums=(0, 1)`` so params
and optimizer state are updated in their own buffers; the port's step
writes them in place (:func:`repro_torch.optim.adamw.adamw_update_`), so
a full-width step holds one copy of its state.  Under autograd the
model's attention takes the JAX package's chunked or direct route
(:func:`repro_torch.models.layers.attention`): a training step launches
none of the port's CUDA kernels, as the JAX package's step runs none of
its Pallas kernels.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ..device import DEFAULT_DEVICE
from ..loops import scan
from ..models.sharding import placed_like
from ..models.zoo import ModelBundle
from ..optim.adamw import (AdamWState, adamw_init, adamw_update_,
                           cosine_schedule)
from ..tree import tree_leaves, tree_map

__all__ = ["make_train_step", "init_train_state", "main"]


def _strided_ready(x, k: int):
    """``x`` with its batch dim split only over the mesh axes whose
    product divides a microbatch's ``B / k`` rows — the major ones
    gathered first, as ``sharding.batch_spec`` degrades a batch that does
    not divide —, so the strided split below keeps each microbatch split
    evenly (grok-1's 16 microbatches of 16 rows over 2 x 16 batch
    shards).  A plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, pl = x.device_mesh, list(x.placements)
    axes = [j for j, p in enumerate(pl)
            if isinstance(p, Shard) and p.dim % x.ndim == 0]
    rows = x.shape[0] // k
    while axes and rows % math.prod(mesh.size(j) for j in axes):
        pl[axes.pop(0)] = Replicate()
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def _rebuild(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_train_step(bundle: ModelBundle,
                    lr_fn: Callable = cosine_schedule(3e-4, 100, 10000),
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``, as the JAX package's:

    - with ``cfg.microbatch`` k > 1 the batch is split *strided*
      (microbatch m is rows m, m + k, ...), each microbatch's gradients
      are accumulated in float32 (in the param dtype when ``cfg.fsdp``),
      and loss and gradients are divided by k;
    - then ``lr_fn(opt_state.step)`` and AdamW.

    The params and moments passed in are updated in place and returned;
    ``loss`` and ``grad_norm`` are 0-d tensors on the params' device,
    ``lr`` a float.

    Params placed on a ``DeviceMesh`` as DTensors (a batch too,
    :func:`repro_torch.models.sharding.distribute_tree`) take the same
    step on every rank: DTensor's propagation shards the compute, each
    gradient is reduced to its param's placements once a step, and AdamW
    updates each rank's shards (the JAX package's ``jit`` with
    ``in_shardings``)."""
    cfg = bundle.cfg

    def grads_of(live, params_like, batch):
        # a leaf the loss does not read (the token embedding of a model
        # fed embeddings) gets zeros, as jax.grad gives it
        loss, _ = bundle.loss_fn(_rebuild(params_like, live), batch)
        return loss.detach(), torch.autograd.grad(
            loss, live, allow_unused=True, materialize_grads=True)

    def train_step(params, opt_state: AdamWState, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        k = cfg.microbatch
        # a plain tensor met by a DTensor op (positions, masks) is read as
        # replicated, as a constant is under jit
        with torch.enable_grad(), implicit_replication():
            if k > 1:
                # STRIDED split, as the JAX package's: microbatch m is rows
                # {m, m + k, ...}, so a batch sharded over the data axis
                # keeps every microbatch sharded over all of it
                mbatch = {n: _strided_ready(x, k).reshape(
                    (x.shape[0] // k, k) + x.shape[1:]).transpose(0, 1)
                    for n, x in batch.items()}
                # a DTensor gradient comes back in the layout its last op
                # left (Partial over the data axis for a replicated
                # param); placed_like reduces it to its param's placements
                # — the data-parallel all-reduce (a no-op on plain tensors)
                def accumulate(carry, mb):
                    gsum, lsum = carry
                    loss_m, g = grads_of(live, params, mb)
                    if gsum is None:
                        # zeros_like: a DTensor gradient's sum keeps its
                        # layout, so partial sums over the data axis add
                        # up locally and are reduced once, below
                        gsum = [torch.zeros_like(gg, dtype=p.dtype
                                                 if cfg.fsdp
                                                 else torch.float32)
                                for gg, p in zip(g, leaves)]
                    for a, gg in zip(gsum, g):
                        a.add_(gg)    # gg promoted element by element
                    del g
                    return (gsum, lsum + loss_m), None

                (gsum, lsum), _ = scan(
                    "train.microbatches", accumulate, (None, 0.0),
                    [{n: x[m] for n, x in mbatch.items()}
                     for m in range(k)])
                grads = [placed_like(a, p).div_(k)
                         for a, p in zip(gsum, leaves)]
                loss = lsum / k
            else:
                loss, grads = grads_of(live, params, batch)
                grads = [placed_like(g, p) for g, p in zip(grads, leaves)]
        del live
        lr = lr_fn(opt_state.step)
        with implicit_replication():
            params, opt_state, gnorm = adamw_update_(
                _rebuild(params, grads), opt_state, params, lr)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


def init_train_state(bundle: ModelBundle, gen: torch.Generator,
                     device=DEFAULT_DEVICE) -> Tuple[Any, AdamWState]:
    """``(params, adamw_init(params))``, params drawn from ``gen`` on
    ``device`` (the card unless the caller names the CPU)."""
    params = bundle.init(gen, device=device)
    return params, adamw_init(params)


def main(argv=None):
    """Generic local training launcher on a reduced config:

        PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
            --steps 50 --seq 128 --batch 8 [--device cpu]
    """
    from ..checkpoint import Checkpointer
    from ..configs import get_config
    from ..data import TokenStream, make_batch_iterator
    from ..device import resolve_device
    from ..models.zoo import get_model
    from ..runtime import TrainLoop

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if cfg.input_kind != "tokens":
        raise SystemExit(f"{args.arch} takes {cfg.input_kind} input, which "
                         f"TokenStream does not make; drive make_train_step "
                         f"with such batches directly")
    bundle = get_model(cfg)
    params, opt = init_train_state(
        bundle, torch.Generator(device=device).manual_seed(0), device=device)
    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    loop = TrainLoop(
        step_fn=make_train_step(bundle),
        batch_iter_fn=lambda s: make_batch_iterator(stream, start_step=s,
                                                    device=device),
        ckpt=Checkpointer(args.ckpt_dir), ckpt_every=25)
    out = loop.run(params, opt, n_steps=args.steps)
    hist = out["history"]
    print(f"loss {hist[0]:.3f} -> {np.mean(hist[-5:]):.3f} "
          f"over {len(hist)} steps")


if __name__ == "__main__":
    main()
