"""Wrappers of the bitserial CUDA kernels.

The kernels (``kernels/csrc/bitserial_mm.cu``, int8 tensor-core MMA) take
the place of the JAX package's Pallas TPU kernel ``bitserial_matmul_planes``
and of the quantize / plane-split / dequantize glue of its int route:

    bitserial_matmul_planes:        out = sum_{i,j} (a_i @ w_j) << 4 (i + j)
                                    int32 (M, N), mod 2^32, over int8 digit
                                    planes a (pa, M, K), w (pw, K, N), any
                                    pa, pw >= 1
    bitserial_quant_matmul_hopper:  y = dequantize(quantize(h) @ quantize(w))
                                    float32 (R, N) from h (R, K), w (K, N);
                                    or (B, R, N) from h (B, R, K) and one w
                                    a batch row, w (B, K, N)

Each wrapper runs its plain PyTorch version (``ref.py``) for a tensor on
the CPU, and for a tensor on the card checks device, type, shape,
contiguity and widths, allocates the output with ``torch.empty``, launches
on the current stream and raises if the launch reports an error.  It
counts its launches in its ``launches`` attribute, a plain integer
incremented once per kernel launch and nowhere else.
"""

from __future__ import annotations

import torch

from ...core import bitwidth as bw
from .ref import ref_bitserial_matmul_planes, ref_bitserial_quant_matmul

__all__ = ["bitserial_matmul_planes", "bitserial_quant_matmul_hopper",
           "launch_counts", "reset_launch_counts"]

def _check(a_planes: torch.Tensor, w_planes: torch.Tensor) -> None:
    from .. import check_operands
    check_operands("bitserial_matmul_planes",
                   {"a_planes": (a_planes, torch.int8),
                    "w_planes": (w_planes, torch.int8)})
    for name, t in (("a_planes", a_planes), ("w_planes", w_planes)):
        if t.ndim != 3 or t.shape[0] < 1:
            raise ValueError(f"{name} {tuple(t.shape)} must be (planes, "
                             f"rows, cols) with one plane or more")
    if a_planes.shape[2] != w_planes.shape[1]:
        raise ValueError(f"a_planes contracts over {a_planes.shape[2]}, "
                         f"w_planes over {w_planes.shape[1]}")


def bitserial_matmul_planes(a_planes: torch.Tensor,
                            w_planes: torch.Tensor) -> torch.Tensor:
    """(pa, M, K) x (pw, K, N) int8 planes -> (M, N) int32, any pa, pw
    >= 1.  Replaces ``repro.kernels.bitserial_mm.kernel.
    bitserial_matmul_planes``; no operand needs padding to a block
    multiple.  A pair whose shift 4 (i + j) reaches 32 adds nothing mod
    2^32, as the TPU kernel's ``lax.shift_left`` gives 0 there."""
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


def _check_widths(aw: int, ww: int) -> None:
    if aw not in bw.VALID_WIDTHS or ww not in bw.VALID_WIDTHS:
        raise ValueError(f"widths ({aw}, {ww}) must each be one of "
                         f"{bw.VALID_WIDTHS}")


_MAX_ROWS_BATCH = 65535          # the per-row launch's grid z


def bitserial_quant_matmul_hopper(h: torch.Tensor, w: torch.Tensor,
                                  aw: int, ww: int) -> torch.Tensor:
    """h (R, K) and w (K, N) float32 -> y (R, N) float32: ``h`` quantized
    per row to ``aw`` bits and ``w`` per column to ``ww`` bits, their
    exact integer product (mod 2^32), dequantized by the two scales — in
    one launch, bit for bit :func:`ref.ref_bitserial_quant_matmul`.

    With h (B, R, K) and w (B, K, N), one operand a batch row, batch row b
    runs against w[b], quantized with w[b]'s own column scales: one launch
    of the per-row kernel, each row bit for bit the shared call on w[b]
    (the kernel is picked by ``w``'s rank, never by the batch)."""
    _check_widths(aw, ww)
    if h.device.type == "cpu":
        return ref_bitserial_quant_matmul(h, w, aw, ww)
    from .. import check_operands
    check_operands("bitserial_quant_matmul_hopper",
                   {"h": (h, torch.float32), "w": (w, torch.float32)})
    rank = w.ndim
    if rank not in (2, 3) or h.ndim != rank \
            or h.shape[-1] != w.shape[-2] or h.shape[-1] == 0 \
            or (rank == 3 and not 1 <= h.shape[0] == w.shape[0]
                <= _MAX_ROWS_BATCH):
        raise ValueError(f"h {tuple(h.shape)} and w {tuple(w.shape)} must "
                         f"be (R, K) and (K, N), or (B, R, K) and (B, K, N) "
                         f"with 1 <= B <= {_MAX_ROWS_BATCH}, with K > 0")
    (r, k), n = h.shape[-2:], w.shape[-1]
    y = torch.empty((*h.shape[:-1], n), dtype=torch.float32,
                    device=h.device)
    if y.numel():
        from .. import launch
        if rank == 2:
            launch("repro_bitserial_quant_matmul", h.device, h.data_ptr(),
                   w.data_ptr(), y.data_ptr(), r, k, n, aw, ww)
        else:
            launch("repro_bitserial_quant_matmul_rows", h.device,
                   h.data_ptr(), w.data_ptr(), y.data_ptr(), h.shape[0], r,
                   k, n, aw, ww)
        bitserial_quant_matmul_hopper.launches += 1
    return y


bitserial_quant_matmul_hopper.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of the wrappers in this module."""
    return {"bitserial_matmul_planes": bitserial_matmul_planes.launches,
            "bitserial_quant_matmul_hopper":
                bitserial_quant_matmul_hopper.launches}


def reset_launch_counts() -> None:
    bitserial_matmul_planes.launches = 0
    bitserial_quant_matmul_hopper.launches = 0
