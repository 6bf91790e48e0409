"""Public FIR wrapper over the phased kernel (the fabric's phased
mapping).  The JAX package's TPU block size ``bm`` and its ``interpret``
switch have no counterpart: the CUDA kernel masks its ragged edge, so no
window row is padded, and the tensor's device picks the kernel or the
plain version."""

from __future__ import annotations

import functools

import torch

from ...core import signal_mapping as sm
from ...core.fabric import device_constant
from .. import forward_only
from .kernel import fir_conv_hopper

__all__ = ["fir_conv"]


@functools.lru_cache(maxsize=32)
def _plan(n: int, taps: int, phases: int) -> sm.FIRPhasePlan:
    return sm.make_fir_phase_plan(n, taps, phases)


def _window_index(plan: sm.FIRPhasePlan, device) -> torch.Tensor:
    """The plan's ``(n / P, L)`` window indices as int32 on ``device``
    (PAD = -1), built once per device and kept on the plan."""
    cache = plan.window.__dict__.setdefault("_fir_conv_idx", {})
    key = str(torch.device(device))
    if key not in cache:
        idx = plan.window.gather_idx.reshape(plan.n // plan.phases,
                                             plan.win_len)
        cache[key] = torch.as_tensor(idx, device=device).contiguous()
    return cache[key]


def fir_conv(x: torch.Tensor, h, phases: int = 8) -> torch.Tensor:
    """Causal FIR along the last axis through the phased kernel.

    x: (..., n) float32; h: (taps,) -> (..., n), equal to
    ``convolve(x, h)[..., :n]``.  ``n`` must be a multiple of
    ``phases``."""
    forward_only("fir_conv", x, h)
    n, taps = x.shape[-1], h.shape[-1]
    plan = _plan(n, taps, phases)
    wbank = sm.fir_phase_weights_torch(
        device_constant(h, x.device, x.dtype), phases).contiguous()
    y = fir_conv_hopper(x.reshape(-1, n).contiguous(),
                        _window_index(plan, x.device), wbank)
    return y[:, :n].reshape(*x.shape[:-1], n)
