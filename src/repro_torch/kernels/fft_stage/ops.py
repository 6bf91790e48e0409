"""Public wrappers: one fused FFT stage, and the full FFT through the
FFT-stage kernel (the counterpart of the JAX package's ``fft_pallas``,
named as ``HopperBackend`` is named after ``PallasBackend``).  The JAX
``interpret`` switch has no counterpart: the tensor's device picks the
kernel or the plain version."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import signal_mapping as sm
from ...core.fabric import apply_plan, device_constant
from .. import forward_only
from .kernel import SHARED_MAX_N2, fft_stage_hopper, fft_stages_hopper

__all__ = ["fft_stage", "fft_hopper", "FUSED_MAX_N"]

FUSED_MAX_N = SHARED_MAX_N2 // 2    # 8192: one launch runs every stage


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


def _stage_list(plan: sm.FFTPlan, device, dtype) -> tuple:
    """``(idx (S, 2n) int32, tw (n - 1, 4, 4), nb, scatter (2n,) int32)``:
    every stage of the fused plan as one list for
    :func:`fft_stages_hopper`, the last stage's scatter as the final
    gather (PAD -1).  Built once per device and type, kept on the
    plan."""
    cache = plan.__dict__.setdefault("_fft_stage_list", {})
    key = (str(torch.device(device)), dtype)
    if key not in cache:
        *inner, last = plan.stages
        sc = last.scatter
        if any(st.scatter.n_out for st in inner) or not sc.n_out \
                or np.any(sc.pad_values[sc.gather_idx < 0]):
            raise ValueError("the stage list takes a fused plan whose last "
                             "stage alone scatters, with zero PAD values")
        idx = np.stack([np.clip(st.gather.gather_idx, 0, None)
                        for st in plan.stages]).astype(np.int32)
        tw = np.concatenate([st.twiddle for st in plan.stages])
        cache[key] = (torch.as_tensor(idx, device=device),
                      torch.as_tensor(tw, device=device).to(dtype),
                      tuple(st.nb for st in plan.stages),
                      torch.as_tensor(sc.gather_idx.astype(np.int32),
                                      device=device))
    return cache[key]


def fft_hopper(x: torch.Tensor) -> torch.Tensor:
    """Full complex FFT along the last axis through the FFT-stage kernel.
    x complex (..., n) -> complex (..., n).

    n <= FUSED_MAX_N (8192): one launch runs every stage in shared
    memory and writes the result through the final scatter
    (:func:`fft_stages_hopper`).  Above that: one launch a stage from
    device memory (:func:`fft_stage`, log2 n launches), then the final
    scatter through ``apply_plan``.  Both branches run the kernel on the
    card; a CPU tensor takes the plain version in either."""
    forward_only("fft_hopper", x)
    n = x.shape[-1]
    plan = _plan(n)
    xr = sm.complex_to_interleaved(x)
    if n <= FUSED_MAX_N:
        xb = xr.reshape(-1, 2 * n).contiguous()
        idx, tw, nb, scatter = _stage_list(plan, x.device, xb.dtype)
        xr = fft_stages_hopper(xb, idx, tw, nb, scatter).reshape(xr.shape)
    else:
        for st in plan.stages:
            xr = fft_stage(xr, st)
            if st.scatter.n_out:           # final stage: back to natural order
                xr = apply_plan(xr, st.scatter)
    return sm.interleaved_to_complex(xr)
