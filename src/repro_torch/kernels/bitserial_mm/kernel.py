"""Wrapper of the bitserial GEMM CUDA kernel.

The kernel (``kernels/csrc/bitserial_mm.cu``) takes the place of the JAX
package's Pallas TPU kernel of the same name:

    out = sum_{i < pa, j < pw} (a_i @ w_j) << 4 (i + j)     (int32, mod 2^32)

over int8 digit planes ``a`` (pa, M, K) and ``w`` (pw, K, N).  The
wrapper runs the plain PyTorch version (``ref.py``) for a tensor on the
CPU, and for a tensor on the card checks device, type, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch reports an error.  It counts its
launches in its ``launches`` attribute, a plain integer incremented once
per kernel launch and nowhere else.
"""

from __future__ import annotations

import torch

from .ref import ref_bitserial_matmul_planes

__all__ = ["bitserial_matmul_planes", "launch_counts", "reset_launch_counts"]

_MAX_PLANES = 4


def _check(a_planes: torch.Tensor, w_planes: torch.Tensor) -> None:
    from .. import check_operands
    check_operands("bitserial_matmul_planes",
                   {"a_planes": (a_planes, torch.int8),
                    "w_planes": (w_planes, torch.int8)})
    for name, t in (("a_planes", a_planes), ("w_planes", w_planes)):
        if t.ndim != 3 or not 1 <= t.shape[0] <= _MAX_PLANES:
            raise ValueError(f"{name} {tuple(t.shape)} must be (planes, "
                             f"rows, cols) with 1..{_MAX_PLANES} planes")
    if a_planes.shape[2] != w_planes.shape[1]:
        raise ValueError(f"a_planes contracts over {a_planes.shape[2]}, "
                         f"w_planes over {w_planes.shape[1]}")


def bitserial_matmul_planes(a_planes: torch.Tensor,
                            w_planes: torch.Tensor) -> torch.Tensor:
    """(pa, M, K) x (pw, K, N) int8 planes -> (M, N) int32.  Replaces
    ``repro.kernels.bitserial_mm.kernel.bitserial_matmul_planes``; no
    operand needs padding to a block multiple."""
    if a_planes.device.type == "cpu":
        return ref_bitserial_matmul_planes(a_planes, w_planes)
    _check(a_planes, w_planes)
    (pa, m, k), (pw, _, n) = a_planes.shape, w_planes.shape
    out = torch.empty((m, n), dtype=torch.int32, device=a_planes.device)
    if out.numel():
        from .. import launch
        launch("repro_bitserial_matmul_planes", a_planes.device,
               a_planes.data_ptr(), w_planes.data_ptr(), out.data_ptr(),
               pa, pw, m, k, n)
        bitserial_matmul_planes.launches += 1
    return out


bitserial_matmul_planes.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of the wrapper in this module."""
    return {"bitserial_matmul_planes": bitserial_matmul_planes.launches}


def reset_launch_counts() -> None:
    bitserial_matmul_planes.launches = 0
