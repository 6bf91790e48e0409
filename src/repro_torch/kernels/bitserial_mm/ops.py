"""Public wrapper of the bitserial GEMM: splits the integer operands into
4-bit digit planes on their device, flattens the batch, runs the kernel
(or, for CPU tensors, its plain version).  The JAX package's TPU block
sizes ``bm``/``bn``/``bk`` and its ``interpret`` switch have no
counterpart: the CUDA kernel masks its ragged edge, so nothing is
padded, and the tensor's device picks the kernel or the plain version."""

from __future__ import annotations

import torch

from ...core import bitwidth as bw
from .kernel import bitserial_matmul_planes

__all__ = ["bitserial_matmul"]


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
