"""Public wrappers: one fused FFT stage, and the full FFT driven stage by
stage through the kernel (the counterpart of the JAX package's
``fft_pallas``, named as ``HopperBackend`` is named after
``PallasBackend``).  The JAX ``interpret`` switch has no counterpart: the
tensor's device picks the kernel or the plain version."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import signal_mapping as sm
from ...core.fabric import apply_plan, device_constant
from .. import forward_only
from .kernel import fft_stage_hopper

__all__ = ["fft_stage", "fft_hopper"]


def _stage_index(stage: sm.FFTStagePlan, device) -> torch.Tensor:
    """The stage's gather indices as int32 on ``device``, PAD clipped to
    index 0 as the JAX package's ``fft_stage`` does (the twiddle column
    a PAD slot meets is zero).  Built once per device, kept on the
    plan."""
    cache = stage.gather.__dict__.setdefault("_fft_stage_idx", {})
    key = str(torch.device(device))
    if key not in cache:
        idx = np.clip(stage.gather.gather_idx, 0, None).astype(np.int32)
        cache[key] = torch.as_tensor(idx, device=device)
    return cache[key]


def fft_stage(x: torch.Tensor, stage: sm.FFTStagePlan) -> torch.Tensor:
    """Apply one fused (gather + butterfly-GEMM) stage.

    x: (..., 2n) interleaved real in the layout the stage's gather
    expects.  Output is in flat (j, b, o) layout (the next stage's
    composed input)."""
    forward_only("fft_stage", x)
    batch = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1]).contiguous()
    tw = device_constant(stage.twiddle, x.device, x.dtype).contiguous()
    y = fft_stage_hopper(xb, _stage_index(stage, x.device), tw, stage.half,
                         stage.nb)
    return y.reshape(*batch, -1)


@functools.lru_cache(maxsize=32)
def _plan(n: int) -> sm.FFTPlan:
    return sm.make_fft_plan(n, fuse_adjacent=True)


def fft_hopper(x: torch.Tensor) -> torch.Tensor:
    """Full complex FFT along the last axis, every stage through the
    fused kernel.  x complex (..., n) -> complex (..., n)."""
    plan = _plan(x.shape[-1])
    xr = sm.complex_to_interleaved(x)
    for st in plan.stages:
        xr = fft_stage(xr, st)
        if st.scatter.n_out:               # final stage: back to natural order
            xr = apply_plan(xr, st.scatter)
    return sm.interleaved_to_complex(xr)
