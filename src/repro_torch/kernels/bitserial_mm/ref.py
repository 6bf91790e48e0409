"""Plain PyTorch versions of the bitserial GEMM.

The bitserial kernel must equal the direct integer GEMM bit-exactly in
32-bit two's-complement arithmetic (wraparound above 2^31, like the
array's fixed-width accumulator).  PyTorch has no integer matmul on
CUDA, so on the card each product is formed in float64, which is exact
while every partial sum stays below 2^53, and is then taken to int64;
on the CPU the product is an int64 matmul.  The wrapper in ``kernel.py``
runs :func:`ref_bitserial_matmul_planes` for tensors on the CPU; the
card-side tests and ``chip_smoke.py`` hold the kernel against it.
:func:`ref_bitserial_quant_matmul` is the int route's composition
(quantize both operands, the exact integer product, dequantize), the
plain version of the one-launch kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core import bitwidth as bw

__all__ = ["ref_bitserial_matmul", "ref_bitserial_matmul_planes",
           "ref_bitserial_quant_matmul", "wrap32"]

_EXACT_F64 = 2 ** 53
_DIGIT_MAX = 15


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 mod 2^32, two's complement."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def _int64_matmul(a: torch.Tensor, w: torch.Tensor,
                  peak: Optional[int] = None) -> torch.Tensor:
    """The exact int64 product of two integer tensors on their device.
    On the card ``peak`` bounds every partial sum's magnitude; without
    it the bound is read from the data (a host synchronisation)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int64), w.to(torch.int64))
    if peak is None:
        peak = (int(a.abs().amax()) if a.numel() else 0) * \
            (int(w.abs().amax()) if w.numel() else 0) * a.shape[-1]
    if peak >= _EXACT_F64:
        raise ValueError(f"an integer product of magnitude up to {peak} is "
                         f"not exact in float64")
    return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(
        torch.int64)


def ref_bitserial_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int64 product wrapped to int32 (mod 2^32, two's complement)."""
    return wrap32(_int64_matmul(a, w))


def ref_bitserial_matmul_planes(a_planes: torch.Tensor,
                                w_planes: torch.Tensor) -> torch.Tensor:
    """(pa, M, K) x (pw, K, N) int8 digit planes, any pa, pw >= 1 ->
    (M, N) int32: ``sum_{i,j} (a_i @ w_j) << 4(i+j)`` mod 2^32, the
    kernel's function.  A pair whose shift reaches 32 adds nothing mod
    2^32 (the TPU kernel's ``lax.shift_left`` of an int32 gives 0 there),
    so it is not formed: an int64 shift of 64 or more would not be
    defined."""
    peak = _DIGIT_MAX ** 2 * a_planes.shape[-1]     # digits lie in [-8, 16)
    acc = torch.zeros((a_planes.shape[1], w_planes.shape[2]),
                      dtype=torch.int64, device=a_planes.device)
    for i in range(a_planes.shape[0]):
        for j in range(w_planes.shape[0]):
            if 4 * (i + j) < 32:
                acc += _int64_matmul(a_planes[i], w_planes[j], peak) \
                    << (4 * (i + j))
    return wrap32(acc)


def ref_bitserial_quant_matmul(h: torch.Tensor, w: torch.Tensor,
                               aw: int, ww: int) -> torch.Tensor:
    """h (..., K) float32 quantized per row to ``aw`` bits, w (K, N) per
    column to ``ww`` bits (:func:`core.bitwidth.quantize`), the integer
    product wrapped to int32, dequantized as ``(acc * h_scale) *
    w_scale`` — the JAX package's int route, step for step.  With one
    ``w`` a batch row, h (B, R, K) and w (B, K, N): batch row b against
    w[b], quantized per column within w[b] (the route inside one lane of
    the JAX package's ``vmap``), each row what the call on w[b] gives."""
    xq, x_scale = bw.quantize(h, aw, axis=-1)
    wq, w_scale = bw.quantize(w, ww, axis=-2)
    # |q| <= qmax: a static bound on the card, so no host synchronisation
    peak = (2 ** (aw - 1) - 1) * (2 ** (ww - 1) - 1) * h.shape[-1]
    acc = wrap32(_int64_matmul(xq, wq, peak))
    return acc.to(torch.float32) * x_scale * w_scale
