"""Plain PyTorch versions of the fused FFT stage kernel.

:func:`ref_fft_stage_hopper` is the kernel's function on the kernel's
arguments (gather by index, then the per-class 4x4 twiddle products,
accumulated in float32); the wrapper in ``kernel.py`` runs it for
tensors on the CPU, and the card-side tests and ``chip_smoke.py`` hold
the kernel against it.  :func:`ref_fft_stage` and :func:`ref_fft` are
the JAX package's oracles: one stage through ``apply_plan``, and the
library FFT.
"""

from __future__ import annotations

import torch

from ...core import signal_mapping as sm
from ...core.fabric import apply_plan, device_constant

__all__ = ["ref_fft_stage_hopper", "ref_fft_stage", "ref_fft"]


def ref_fft_stage_hopper(x: torch.Tensor, idx: torch.Tensor,
                         tw: torch.Tensor, half: int, nb: int
                         ) -> torch.Tensor:
    """x (B, 2n); idx (2n,) in [0, 2n); tw (half, 4, 4) -> (B, 2n) in
    flat (j, blk, o) order: ``y[j, blk, o] = sum_i tw[j, o, i] *
    x[idx[(j * nb + blk) * 4 + i]]``."""
    rows = x[:, idx.long()].reshape(x.shape[0], half, nb, 4)
    y = torch.einsum("bjni,joi->bjno", rows, tw)
    return y.reshape(x.shape[0], -1)


def ref_fft_stage(x: torch.Tensor, stage: sm.FFTStagePlan) -> torch.Tensor:
    """One stage through the fabric oracle: ``apply_plan``, then the
    twiddle einsum."""
    rows = apply_plan(x, stage.gather)
    rows = rows.reshape(*rows.shape[:-1], stage.half, stage.nb, 4)
    tw = device_constant(stage.twiddle, rows.device, rows.dtype)
    y = torch.einsum("...jbi,joi->...jbo", rows, tw)
    return y.reshape(*y.shape[:-3], -1)


def ref_fft(x: torch.Tensor) -> torch.Tensor:
    """End-to-end oracle: ``torch.fft.fft``."""
    return torch.fft.fft(x)
