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

The per-row form runs one of three bodies, chosen from (K, N) alone by
:func:`quant_rows_body`; :func:`quant_rows_launch_args` gives a launch's C
arguments, whose ``dims`` array holds, after the launch, the body it ran
and its grid.
"""

from __future__ import annotations

import ctypes

import torch

from ...core import bitwidth as bw
from .ref import ref_bitserial_matmul_planes, ref_bitserial_quant_matmul

__all__ = ["bitserial_matmul_planes", "bitserial_quant_matmul_hopper",
           "quant_rows_body", "quant_rows_launch_args", "QUANT_ROWS_BODIES",
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


_MAX_INT = 2 ** 31 - 1            # the C entries take sizes as ints

# The per-row entry's bodies (``repro_bitserial_quant_matmul_rows``, its
# dims' first int): "row" on the CUDA cores with no staging of h, "tiles"
# on the int8 tensor cores with w's column tile quantized once a CTA,
# "chunked" (K past the tiles body's single chunk) the shared kernel's
# body with one w a batch row.
QUANT_ROWS_BODIES = ("row", "tiles", "chunked")
ROW_MAX_K, ROW_MAX_N = 32, 8     # kRowMaxK, kRowMaxN in csrc/bitserial_mm.cu
TILES_MAX_K = 256                # kTilesMaxK
_ROWS_DIMS = ctypes.c_int * 4    # kRowsDims


def quant_rows_body(k: int, n: int) -> str:
    """The body the per-row entry runs for a call of depth ``k`` and
    width ``n``: the C dispatch's rule (``rows_body``), set by timing the
    row body against the tiles body at Fig-9q's three calls.  It reads
    neither the batch nor the rows, so every batch row of every batch
    runs the same arithmetic."""
    if k <= ROW_MAX_K and n <= ROW_MAX_N:
        return "row"
    return "tiles" if k <= TILES_MAX_K else "chunked"


def _check_quant(h: torch.Tensor, w: torch.Tensor) -> None:
    from .. import check_operands
    check_operands("bitserial_quant_matmul_hopper",
                   {"h": (h, torch.float32), "w": (w, torch.float32)})
    rank = w.ndim
    if rank not in (2, 3) or h.ndim != rank \
            or h.shape[-1] != w.shape[-2] or h.shape[-1] == 0 \
            or (rank == 3 and not 1 <= h.shape[0] == w.shape[0]
                <= _MAX_INT):
        raise ValueError(f"h {tuple(h.shape)} and w {tuple(w.shape)} must "
                         f"be (R, K) and (K, N), or (B, R, K) and (B, K, N) "
                         f"with 1 <= B <= {_MAX_INT}, with K > 0")


def quant_rows_launch_args(h: torch.Tensor, w: torch.Tensor, aw: int,
                           ww: int) -> tuple:
    """Check a per-row call on the card (h (B, R, K), w (B, K, N)) and
    allocate its output: ``(y, args)`` with ``args`` the arguments of the
    C entry ``repro_bitserial_quant_matmul_rows`` before the stream.  Its
    ``dims`` array (``args[9]``) holds, after the launch, the body (an
    index into :data:`QUANT_ROWS_BODIES`), the grid's x and y, and the M
    tiles (row body: rows) a CTA."""
    _check_widths(aw, ww)
    _check_quant(h, w)
    if w.ndim != 3:
        raise ValueError(f"the per-row entry takes w (B, K, N); got "
                         f"{tuple(w.shape)}")
    (b, r, k), n = h.shape, w.shape[-1]
    y = torch.empty((b, r, n), dtype=torch.float32, device=h.device)
    return y, (h.data_ptr(), w.data_ptr(), y.data_ptr(), b, r, k, n, aw, ww,
               _ROWS_DIMS())


def bitserial_quant_matmul_hopper(h: torch.Tensor, w: torch.Tensor,
                                  aw: int, ww: int) -> torch.Tensor:
    """h (R, K) and w (K, N) float32 -> y (R, N) float32: ``h`` quantized
    per row to ``aw`` bits and ``w`` per column to ``ww`` bits, their
    exact integer product (mod 2^32), dequantized by the two scales — in
    one launch, bit for bit :func:`ref.ref_bitserial_quant_matmul`.

    With h (B, R, K) and w (B, K, N), one operand a batch row, batch row b
    runs against w[b], quantized with w[b]'s own column scales: one launch
    of the per-row entry, on the body :func:`quant_rows_body` gives (K, N),
    each row bit for bit the shared call on w[b], at any batch."""
    _check_widths(aw, ww)
    if h.device.type == "cpu":
        return ref_bitserial_quant_matmul(h, w, aw, ww)
    from .. import launch
    if w.ndim == 3:
        y, args = quant_rows_launch_args(h, w, aw, ww)
        if y.numel():
            launch("repro_bitserial_quant_matmul_rows", h.device, *args)
            bitserial_quant_matmul_hopper.launches += 1
        return y
    _check_quant(h, w)
    (r, k), n = h.shape, w.shape[-1]
    y = torch.empty((r, n), dtype=torch.float32, device=h.device)
    if y.numel():
        launch("repro_bitserial_quant_matmul", h.device, h.data_ptr(),
               w.data_ptr(), y.data_ptr(), r, k, n, aw, ww)
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
