"""Deterministic synthetic data: the counterpart of the JAX package's
``data/pipeline.py``, in numpy.

Every batch is a pure function of ``(seed, step)``, drawn with the same
numpy calls in the same order as the JAX package, so both give the same
batches bit for bit: Zipf-distributed token ids with short-range Markov
structure (:class:`TokenStream`) for the language models, and noisy
multi-sine "speech-like" signals with their clean targets
(:class:`SignalStream`) for the Fig-9 training path.
:func:`make_batch_iterator` feeds a training loop from a stream, one
step-addressed batch at a time, so a restarted loop reads the batches it
would have read, whole or sharded over a ``DeviceMesh``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.sharding import distribute_tree

__all__ = ["TokenStream", "SignalStream", "make_batch_iterator"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s = self.global_batch, self.seq_len
        # Zipf base draw
        ranks = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        tokens = (ranks - 1) % self.vocab
        # Markov structure: with p=0.5, token t+1 = (token t + small) % V
        carry = rng.random((b, s)) < 0.5
        shifted = (tokens + rng.integers(1, 17, size=(b, s))) % self.vocab
        out = np.where(carry, np.roll(shifted, 1, axis=1), tokens)
        return out.astype(np.int32)


@dataclasses.dataclass
class SignalStream:
    """Noisy multi-sine 'speech-like' signals + clean targets."""
    length: int
    global_batch: int
    fs: float = 16000.0
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 7]))
        b, n = self.global_batch, self.length
        t = np.arange(n) / self.fs
        clean = np.zeros((b, n), np.float32)
        for _ in range(4):
            f = rng.uniform(80.0, 3500.0, size=(b, 1))
            a = rng.uniform(0.2, 1.0, size=(b, 1))
            ph = rng.uniform(0, 2 * np.pi, size=(b, 1))
            clean += (a * np.sin(2 * np.pi * f * t[None] + ph)
                      ).astype(np.float32)
        noise = rng.normal(0.0, 0.8, size=(b, n)).astype(np.float32)
        return {"noisy": clean + noise, "clean": clean}



def make_batch_iterator(stream, cfg=None, sharding=None, start_step: int = 0,
                        device=DEFAULT_DEVICE) -> Iterator:
    """Yields ``(step, {name: tensor})`` from ``stream.batch_at(step)``
    for ``step = start_step, start_step + 1, ...``, each batch's arrays
    copied to ``device`` (the card unless the caller names the CPU); a
    bare array is the batch's ``"tokens"``.  ``cfg`` is accepted for the
    JAX package's signature and unused there too.

    ``sharding``: a :class:`~repro_torch.models.sharding.NamedSharding`
    bound to a ``DeviceMesh`` (``row_sharding(mesh, (batch, seq))``):
    every rank draws the global batch, as the JAX package's single
    controller does, and keeps its own block of each array as a DTensor
    placed by the spec (nothing is sent: the ranks draw the same
    batch) on the mesh's device type, which stands in for ``device``."""
    if sharding is not None and not isinstance(
            getattr(sharding, "mesh", None), DeviceMesh):
        raise TypeError(f"make_batch_iterator(sharding=): a NamedSharding "
                        f"bound to a DeviceMesh, not {sharding!r}")
    dev = resolve_device(device if sharding is None
                         else sharding.mesh.device_type)

    def put(v):
        if sharding is None:
            return torch.as_tensor(v, device=dev)
        return distribute_tree(torch.as_tensor(v, device=dev),
                               sharding.spec, sharding.mesh)

    def batches():
        step = start_step
        while True:
            raw = stream.batch_at(step)
            if isinstance(raw, np.ndarray):
                raw = {"tokens": raw}
            yield step, {k: put(v) for k, v in raw.items()}
            step += 1
    return batches()
