"""Wrapper of the fused FFT stage CUDA kernel.

The kernel (``kernels/csrc/fft_stage.cu``) takes the place of the JAX
package's Pallas TPU kernel ``fft_stage_pallas``: one radix-2 DIT stage,
a gather of the 2n interleaved reals by the stage's plan followed by the
per-twiddle-class (nb, 4) x (4, 4) products.  The wrapper runs the plain
PyTorch version (``ref.py``) for a tensor on the CPU, and for a tensor
on the card checks device, type, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream and raises
if the launch reports an error.  It counts its launches in its
``launches`` attribute, a plain integer incremented once per kernel
launch and nowhere else.

Indices must lie in ``[0, 2n)``; the kernel does not bounds-check them
(``ops.py`` clips the plan's PAD entries to 0, as the JAX package does).
"""

from __future__ import annotations

import torch

from .ref import ref_fft_stage_hopper

__all__ = ["fft_stage_hopper", "launch_counts", "reset_launch_counts"]

_MAX_GRID_Y = 65535


def _check(x, idx, tw, half, nb):
    from .. import check_operands
    check_operands("fft_stage_hopper", {"x": (x, torch.float32),
                                        "idx": (idx, torch.int32),
                                        "tw": (tw, torch.float32)})
    n2 = half * nb * 4
    if x.ndim != 2 or x.shape[1] != n2 or tuple(idx.shape) != (n2,) \
            or tuple(tw.shape) != (half, 4, 4):
        raise ValueError(f"shapes: x {tuple(x.shape)} must be (B, {n2}), "
                         f"idx {tuple(idx.shape)} ({n2},), tw "
                         f"{tuple(tw.shape)} ({half}, 4, 4)")
    if x.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"batch {x.shape[0]} exceeds {_MAX_GRID_Y}")


def fft_stage_hopper(x: torch.Tensor, idx: torch.Tensor, tw: torch.Tensor,
                     half: int, nb: int) -> torch.Tensor:
    """x: (B, 2n) interleaved real; idx: (2n,) int32; tw: (half, 4, 4)
    -> (B, 2n).  Replaces ``repro.kernels.fft_stage.kernel.
    fft_stage_pallas``."""
    if x.device.type == "cpu":
        return ref_fft_stage_hopper(x, idx, tw, half, nb)
    _check(x, idx, tw, half, nb)
    out = torch.empty_like(x)
    if out.numel():
        from .. import launch
        launch("repro_fft_stage", x.device, x.data_ptr(), idx.data_ptr(),
               tw.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], nb)
        fft_stage_hopper.launches += 1
    return out


fft_stage_hopper.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of the wrapper in this module."""
    return {"fft_stage_hopper": fft_stage_hopper.launches}


def reset_launch_counts() -> None:
    fft_stage_hopper.launches = 0
