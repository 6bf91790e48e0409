"""Deterministic synthetic signal data: the counterpart of
``SignalStream`` in the JAX package's ``data/pipeline.py``, in numpy.

Every batch is a pure function of ``(seed, step)``, drawn with the same
numpy calls in the same order as the JAX package, so both give the same
batches bit for bit: noisy multi-sine "speech-like" signals and their
clean targets for the Fig-9 training path."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SignalStream"]


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
