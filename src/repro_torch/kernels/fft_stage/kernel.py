"""Wrappers of the FFT-stage CUDA kernel.

The kernel (``kernels/csrc/fft_stage.cu``) takes the place of the JAX
package's Pallas TPU kernel ``fft_stage_pallas``: a radix-2 DIT stage is
a gather of the 2n interleaved reals by the stage's plan followed by the
per-twiddle-class (nb, 4) x (4, 4) products.  One kernel body runs a list
of S stages: :func:`fft_stages_hopper` launches it once for the whole
list (every stage in shared memory, then an optional final scatter), and
:func:`fft_stage_hopper`, the counterpart of ``fft_stage_pallas``, is the
list of one stage.  Each wrapper runs the plain PyTorch version
(``ref.py``) for a tensor on the CPU, and for a tensor on the card checks
device, type, shape and contiguity, allocates the output with
``torch.empty``, launches on the current stream and raises if the launch
reports an error.  The launches of the body, from either wrapper, are
counted in ``fft_stages_hopper.launches``, a plain integer incremented
once per kernel launch and nowhere else.

Indices must lie in ``[0, 2n)`` (the scatter's in ``[-1, 2n)``, -1 being
PAD); the kernel does not bounds-check them (``ops.py`` clips the plans'
PAD gather entries to 0, as the JAX package does).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .ref import ref_fft_stage_hopper, ref_fft_stages_hopper

__all__ = ["fft_stages_hopper", "fft_stage_hopper", "launch_counts",
           "reset_launch_counts", "SHARED_MAX_N2", "MAX_STAGES"]

SHARED_MAX_N2 = 16384   # two 2n-float buffers in 128 KB of shared memory
MAX_STAGES = 16


def _check(x, idx, tw, nb, scatter):
    from .. import check_operands
    ops = {"x": (x, torch.float32), "idx": (idx, torch.int32),
           "tw": (tw, torch.float32)}
    if scatter is not None:
        ops["scatter"] = (scatter, torch.int32)
    check_operands("fft_stages_hopper", ops)
    n2 = x.shape[-1] if x.ndim == 2 else -1
    halves = [n2 // 4 // b if b > 0 and n2 > 0 and (n2 // 4) % b == 0
              else -1 for b in nb]
    if x.ndim != 2 or n2 < 4 or n2 % 4 or not 1 <= len(nb) <= MAX_STAGES \
            or -1 in halves or tuple(idx.shape) != (len(nb), n2) \
            or tuple(tw.shape) != (sum(halves), 4, 4) \
            or (scatter is not None and tuple(scatter.shape) != (n2,)):
        raise ValueError(f"shapes: x {tuple(x.shape)} must be (B, 2n), idx "
                         f"{tuple(idx.shape)} ({len(nb)}, 2n), tw "
                         f"{tuple(tw.shape)} (sum of 2n / 4 / nb, 4, 4) for "
                         f"nb {tuple(nb)}, scatter (2n,)")
    if n2 > SHARED_MAX_N2 and (len(nb) != 1 or scatter is not None):
        raise ValueError(f"2n = {n2} exceeds shared memory "
                         f"({SHARED_MAX_N2}): one stage a launch, no scatter")


def fft_stages_hopper(x: torch.Tensor, idx: torch.Tensor, tw: torch.Tensor,
                      nb: Sequence[int],
                      scatter: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """x: (B, 2n) interleaved real; idx: (S, 2n) int32, stage s's gather;
    tw: (sum of halves, 4, 4), the stages' twiddles concatenated (stage s
    has half = 2n / 4 / nb[s] classes); scatter: None or (2n,) int32, the
    final gather back to natural order (-1 = PAD -> 0) -> (B, 2n), in one
    launch.  A list of several stages, or one with a scatter, runs in
    shared memory and needs 2n <= SHARED_MAX_N2; one stage without
    scatter runs from device memory at any length."""
    nb = tuple(int(b) for b in nb)
    if x.device.type == "cpu":
        return ref_fft_stages_hopper(x, idx, tw, nb, scatter)
    _check(x, idx, tw, nb, scatter)
    out = torch.empty_like(x)
    if out.numel():
        from .. import launch
        launch("repro_fft_stages", x.device, x.data_ptr(), idx.data_ptr(),
               tw.data_ptr(), None if scatter is None else scatter.data_ptr(),
               out.data_ptr(), x.shape[0], x.shape[1], len(nb),
               (ctypes.c_int * len(nb))(*nb))
        fft_stages_hopper.launches += 1
    return out


fft_stages_hopper.launches = 0


def fft_stage_hopper(x: torch.Tensor, idx: torch.Tensor, tw: torch.Tensor,
                     half: int, nb: int) -> torch.Tensor:
    """x: (B, 2n) interleaved real; idx: (2n,) int32; tw: (half, 4, 4)
    -> (B, 2n): one stage, the list of one.  Replaces
    ``repro.kernels.fft_stage.kernel.fft_stage_pallas``."""
    if x.device.type == "cpu":
        return ref_fft_stage_hopper(x, idx, tw, half, nb)
    n2 = half * nb * 4
    if x.ndim != 2 or x.shape[1] != n2 or tuple(idx.shape) != (n2,) \
            or tuple(tw.shape) != (half, 4, 4):
        raise ValueError(f"shapes: x {tuple(x.shape)} must be (B, {n2}), "
                         f"idx {tuple(idx.shape)} ({n2},), tw "
                         f"{tuple(tw.shape)} ({half}, 4, 4)")
    return fft_stages_hopper(x, idx.reshape(1, n2), tw, (nb,))


def launch_counts() -> dict:
    """``{kernel name: launches}`` of the kernel in this module."""
    return {"fft_stages_hopper": fft_stages_hopper.launches}


def reset_launch_counts() -> None:
    fft_stages_hopper.launches = 0
