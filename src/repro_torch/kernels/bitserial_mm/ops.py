"""Public wrappers of the bitserial GEMM.  :func:`bitserial_matmul` splits
the integer operands into 4-bit digit planes on their device, flattens
the batch and runs the planes kernel (or, for CPU tensors, its plain
version); :func:`bitserial_quant_matmul` hands float operands to the
one-launch quantize -> GEMM -> dequantize kernel, the int route's step.
The JAX package's TPU block sizes ``bm``/``bn``/``bk`` and its
``interpret`` switch have no counterpart: the CUDA kernels mask their
ragged edge, so nothing is padded, and the tensor's device picks the
kernel or the plain version."""

from __future__ import annotations

import torch

from ...core import bitwidth as bw
from .kernel import bitserial_matmul_planes, bitserial_quant_matmul_hopper

__all__ = ["bitserial_matmul", "bitserial_quant_matmul"]


def bitserial_matmul(a: torch.Tensor, w: torch.Tensor,
                     a_width: int = 8, w_width: int = 8) -> torch.Tensor:
    """Exact integer matmul a @ w on the variable-bitwidth array.

    a: (..., M, K) ints of ``a_width`` bits; w: (K, N) of ``w_width``
    bits.  Returns int32 (..., M, N) equal to the integer product mod
    2^32 (the array's 32-bit accumulator)."""
    batch, (m, k), n = a.shape[:-2], a.shape[-2:], w.shape[-1]
    if w.ndim != 2 or w.shape[0] != k:
        raise ValueError(f"w {tuple(w.shape)} must be (K={k}, N)")
    a2 = a.reshape(-1, k)
    a_planes = torch.stack(bw.split_planes(a2, a_width)).contiguous()
    w_planes = torch.stack(bw.split_planes(w, w_width)).contiguous()
    out = bitserial_matmul_planes(a_planes, w_planes)
    return out.reshape(*batch, m, n)


def bitserial_quant_matmul(h: torch.Tensor, w: torch.Tensor,
                           aw: int, ww: int) -> torch.Tensor:
    """``dequantize(quantize(h) @ quantize(w))`` of h (..., R, K) float32
    against w (K, N) float32: h per row at ``aw`` bits, w per column at
    ``ww`` bits, the integer product exact mod 2^32 — the JAX package's
    int-route forward (``quantize`` x2, ``bitserial_matmul``, two
    multiplies) in one kernel launch.  Returns float32 (..., R, N).

    With w (B, K, N), one operand a batch row, h is (B, ..., R, K) and
    batch row b contracts against w[b] with w[b]'s own column scales
    (a served wave of graphs that registered different weights): one
    launch of the per-row kernel."""
    k, n = h.shape[-1], w.shape[-1]
    if w.ndim == 3:
        if w.shape[1] != k or h.ndim < 2 or h.shape[0] != w.shape[0]:
            raise ValueError(f"per-row w {tuple(w.shape)} needs h (B, ..., "
                             f"K) with B = {w.shape[0]}, K = {w.shape[1]}; "
                             f"got {tuple(h.shape)}")
        y = bitserial_quant_matmul_hopper(
            h.reshape(h.shape[0], -1, k).contiguous(), w.contiguous(), aw,
            ww)
        return y.reshape(*h.shape[:-1], n)
    if w.ndim != 2 or w.shape[0] != k:
        raise ValueError(f"w {tuple(w.shape)} must be (K={k}, N)")
    y = bitserial_quant_matmul_hopper(h.reshape(-1, k).contiguous(),
                                      w.contiguous(), aw, ww)
    return y.reshape(*h.shape[:-1], n)
