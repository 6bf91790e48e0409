"""Plain PyTorch versions of the FFT-stage kernel.

:func:`ref_fft_stage_hopper` is one stage on the kernel's arguments
(gather by index, then the per-class 4x4 twiddle products, accumulated in
float32), and :func:`ref_fft_stages_hopper` a list of stages, one after
the other, followed by the final scatter; the wrappers in ``kernel.py``
run them for tensors on the CPU, and the card-side tests and
``chip_smoke.py`` hold the kernel against them.  :func:`ref_fft_stage`
and :func:`ref_fft` are the JAX package's oracles: one stage through
``apply_plan``, and the library FFT.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...core import signal_mapping as sm
from ...core.fabric import apply_plan, device_constant

__all__ = ["ref_fft_stage_hopper", "ref_fft_stages_hopper", "ref_fft_stage",
           "ref_fft"]


def ref_fft_stage_hopper(x: torch.Tensor, idx: torch.Tensor,
                         tw: torch.Tensor, half: int, nb: int
                         ) -> torch.Tensor:
    """x (B, 2n); idx (2n,) in [0, 2n); tw (half, 4, 4) -> (B, 2n) in
    flat (j, blk, o) order: ``y[j, blk, o] = sum_i tw[j, o, i] *
    x[idx[(j * nb + blk) * 4 + i]]``."""
    rows = x[:, idx.long()].reshape(x.shape[0], half, nb, 4)
    y = torch.einsum("bjni,joi->bjno", rows, tw)
    return y.reshape(x.shape[0], -1)


def ref_fft_stages_hopper(x: torch.Tensor, idx: torch.Tensor,
                          tw: torch.Tensor, nb: Sequence[int],
                          scatter: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """x (B, 2n); idx (S, 2n); tw the S stages' twiddles concatenated
    (stage s has half = 2n / 4 / nb[s] classes); scatter None or (2n,) in
    [-1, 2n) -> (B, 2n): :func:`ref_fft_stage_hopper` stage by stage, then
    ``y[:, c] = x[:, scatter[c]]``, 0 where ``scatter[c]`` is PAD (-1), as
    ``apply_plan`` fills a plan's zero PAD values."""
    row = 0
    for s, b in enumerate(nb):
        half = x.shape[-1] // 4 // b
        x = ref_fft_stage_hopper(x, idx[s], tw[row:row + half], half, b)
        row += half
    if scatter is None:
        return x
    g = x[:, scatter.clamp(min=0).long()]
    return torch.where(scatter >= 0, g, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


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
