"""Wrapper of the phased FIR CUDA kernel.

The kernel (``kernels/csrc/fir_conv.cu``) takes the place of the JAX
package's Pallas TPU kernel ``fir_conv_pallas``: a window gather
(``(M, L)`` indices, PAD = -1 read as 0) times an ``(L, P)`` tap bank,
``P`` outputs per window.  The wrapper runs the plain PyTorch version
(``ref.py``) for a tensor on the CPU, and for a tensor on the card checks
device, type, shape and contiguity, allocates the output with
``torch.empty``, launches on the current stream and raises if the launch
reports an error.  It counts its launches in its ``launches`` attribute,
a plain integer incremented once per kernel launch and nowhere else.

Indices must lie in ``[-1, n)``; the kernel does not bounds-check them
(``ops.py`` passes the plan builder's windows, which do).
"""

from __future__ import annotations

import torch

from .ref import ref_fir_conv_hopper

__all__ = ["fir_conv_hopper", "launch_counts", "reset_launch_counts"]

_MAX_GRID_Y = 65535


def _check(x, idx, wbank):
    from .. import check_operands
    check_operands("fir_conv_hopper", {"x": (x, torch.float32),
                                       "idx": (idx, torch.int32),
                                       "wbank": (wbank, torch.float32)})
    if x.ndim != 2 or idx.ndim != 2 or wbank.ndim != 2 \
            or wbank.shape[0] != idx.shape[1]:
        raise ValueError(f"shapes: x {tuple(x.shape)} must be (B, n), idx "
                         f"{tuple(idx.shape)} (M, L), wbank "
                         f"{tuple(wbank.shape)} (L, P)")
    if x.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"batch {x.shape[0]} exceeds {_MAX_GRID_Y}")


def fir_conv_hopper(x: torch.Tensor, idx: torch.Tensor,
                    wbank: torch.Tensor) -> torch.Tensor:
    """x: (B, n); idx: (M, L) int32, PAD = -1; wbank: (L, P) ->
    (B, M * P).  Replaces ``repro.kernels.fir_conv.kernel.
    fir_conv_pallas``; window rows need no padding to a block
    multiple."""
    if x.device.type == "cpu":
        return ref_fir_conv_hopper(x, idx, wbank)
    _check(x, idx, wbank)
    (b, n), (m, win), phases = x.shape, idx.shape, wbank.shape[1]
    out = torch.empty((b, m * phases), dtype=x.dtype, device=x.device)
    if out.numel():
        from .. import launch
        launch("repro_fir_conv", x.device, x.data_ptr(), idx.data_ptr(),
               wbank.data_ptr(), out.data_ptr(), b, n, m, win, phases)
        fir_conv_hopper.launches += 1
    return out


fir_conv_hopper.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of the wrapper in this module."""
    return {"fir_conv_hopper": fir_conv_hopper.launches}


def reset_launch_counts() -> None:
    fir_conv_hopper.launches = 0
