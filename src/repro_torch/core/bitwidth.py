"""Variable-bitwidth arithmetic: the SigDLA computing array (paper §IV).

The array is built from 4-bit multipliers; 8/16-bit multiplies are
decomposed recursively into 4-bit plane products recombined with shift-add
(Fig. 2: shifts 0/4/4/8 for 8x8, up to 24 for 16x16).  We model the operand
decomposition exactly:

    a = sum_i a_i * 16^i ,  a_i in [0,16) for i < k-1,  top digit signed

so a WxW product is sum_{i,j} a_i * w_j << 4(i+j) — *bit-exact* with the
int32 product.  `plane_matmul` is the plain torch composition; the
bitserial CUDA kernel (:mod:`repro_torch.kernels.bitserial_mm`) performs
the same per-plane products on int8 digit planes.

Also provides symmetric per-channel quantization used by the quantized
serving path — the IoT-style 4/8/16-bit menu of the paper mapped onto
LLM weight quantization.  ``torch.round`` rounds half to even, as the
JAX package's rounding does, so quantized values agree bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

VALID_WIDTHS = (4, 8, 16)

ACC_BITS = 31          # magnitude bits of the array's int32 accumulator


def n_planes(width: int) -> int:
    if width not in VALID_WIDTHS:
        raise ValueError(f"width must be one of {VALID_WIDTHS}")
    return width // 4


def int_headroom_bits(a_width: int, w_width: int, k: int) -> int:
    """Accumulator magnitude bits a worst-case ``k``-term integer dot
    product needs at ``(a_width, w_width)``: each quantized product is
    ``< 2^(aw+ww-2)`` (symmetric quantization, ``|q| <= 2^(w-1)-1``) and
    ``k`` of them sum per output, so the accumulation fits the int32
    array accumulator iff this is ``<= ACC_BITS`` (31).  Shared by the
    bind-time guard in :mod:`repro_torch.signal.backends` and the
    SigQuant width solver."""
    return a_width + w_width - 2 + math.ceil(math.log2(max(k, 1)))


def max_contraction(a_width: int, w_width: int,
                    acc_bits: int = ACC_BITS) -> int:
    """Largest contraction size ``K`` the accumulator provably holds at
    ``(a_width, w_width)`` — the worst-case inverse of
    :func:`int_headroom_bits`.  The 4-bit activation edge: ``(4, 4)``
    admits ``K = 2^25`` exactly; one more term can wrap."""
    return 2 ** (acc_bits - (a_width + w_width - 2))


def split_planes(x: torch.Tensor, width: int) -> List[torch.Tensor]:
    """Decompose signed ``width``-bit integers into base-16 digit planes.

    Lower planes are unsigned in [0, 16); the top plane is the signed
    arithmetic remainder, so sum_i plane_i * 16^i == x exactly.  Planes are
    returned as int8 (they feed int8 tensor-core passes on hardware).
    """
    k = n_planes(width)
    x = x.to(torch.int32)
    planes = []
    for i in range(k):
        if i < k - 1:
            planes.append(((x >> (4 * i)) & 0xF).to(torch.int8))
        else:
            planes.append((x >> (4 * i)).to(torch.int8))  # arithmetic: keeps sign
    return planes


def compose_planes(planes: List[torch.Tensor]) -> torch.Tensor:
    acc = torch.zeros_like(planes[0], dtype=torch.int32)
    for i, p in enumerate(planes):
        acc = acc + (p.to(torch.int32) << (4 * i))
    return acc


def plane_matmul(a: torch.Tensor, w: torch.Tensor,
                 a_width: int, w_width: int) -> torch.Tensor:
    """Exact integer matmul via 4-bit plane decomposition (the SigDLA array).

    a: (..., M, K) signed ints of a_width bits; w: (K, N) of w_width bits.
    Result: int32 (..., M, N), bit-exact with the direct product **in
    32-bit two's-complement arithmetic** — i.e. equal to the true product
    mod 2^32, exactly like the array's fixed-width accumulator.  Each
    per-plane partial sum is exact (|4b x 4b| <= 225 per term) and is
    formed in int64 before the int32 accumulation.  Shift schedule is
    4*(i+j): 0/4/4/8 for 8x8, max 24 for 16x16 (Fig 2).  Integer matmul
    is a CPU operator in PyTorch; on the card the same product runs
    through :func:`repro_torch.kernels.bitserial_matmul`.
    """
    a_planes = split_planes(a, a_width)
    w_planes = split_planes(w, w_width)
    acc = None
    for i, ap in enumerate(a_planes):
        for j, wp in enumerate(w_planes):
            part = torch.matmul(ap.to(torch.int64), wp.to(torch.int64))
            part = part.to(torch.int32) << (4 * (i + j))
            acc = part if acc is None else acc + part
    return acc


def macs_per_cycle(a_width: int, w_width: int, n_mult4: int = 128) -> float:
    """Throughput of the serial array: one WxW MAC consumes
    (a_width/4)*(w_width/4) four-bit multipliers (paper §IV / Fig 7)."""
    return n_mult4 / (n_planes(a_width) * n_planes(w_width))


# --------------------------------------------------------------------------
# Quantization helpers (per-channel symmetric)
# --------------------------------------------------------------------------

def quantize(x: torch.Tensor, width: int, axis: int = -1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel quantization to signed ``width``-bit ints.

    Returns (q, scale) with x ~= q * scale; q in [-(2^(w-1)-1), 2^(w-1)-1].
    """
    qmax = float(2 ** (width - 1) - 1)
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    # qmax divides as a tensor on x's device: PyTorch's CUDA kernel divides
    # by a Python number as a multiply by its float32 reciprocal, which
    # misses the true quotient in the last bit for many rows.  So the scale
    # is the IEEE quotient on every device, as in the JAX package's int
    # route and in the one-launch bitserial kernel.
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantized_matmul(x: torch.Tensor, wq: torch.Tensor,
                     w_scale: torch.Tensor, a_width: int = 8,
                     w_width: int = 4) -> torch.Tensor:
    """Fake-int path used as reference for the bitserial kernel-backed linear:
    quantize activations per-row, integer matmul via plane decomposition,
    dequantize with the product of scales."""
    xq, x_scale = quantize(x, a_width, axis=-1)
    acc = plane_matmul(xq, wq, a_width, w_width)
    # x_scale: (..., M, 1); w_scale (per out-channel, quantize axis=0): (1, N)
    return acc.to(torch.float32) * x_scale * w_scale
