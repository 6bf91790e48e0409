"""Wrapper of the flash-attention CUDA kernel.

The kernel (``kernels/csrc/flash_attention.cu``) takes the place of the
JAX package's Pallas TPU kernel ``flash_attention_bhsd``: online-softmax
attention with GQA (query head ``h`` reads kv head ``h // (H / KV)``),
causal and sliding-window masks, a tanh logit softcap and ragged tails,
float32 running state, output in the query's type.  It reads the entry
point's ``(B, S, H, hd)`` layout directly, so nothing is transposed.
float32 runs on the FMA pipes; bfloat16 runs on the tensor cores
(``wgmma`` fed by TMA, P rounded to bfloat16 before P V), at every head
dim the wrapper takes.

The wrapper runs the plain PyTorch version (``ref.py``) for a tensor on
the CPU, and for a tensor on the card checks device, type, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch reports an error.  It counts its
launches in its ``launches`` attribute, a plain integer incremented once
per kernel launch and nowhere else.
"""

from __future__ import annotations

import torch

from .ref import ref_attention

__all__ = ["flash_attention_hopper", "launch_counts", "reset_launch_counts",
           "MAX_HEAD_DIM"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
MAX_HEAD_DIM = 256      # gemma2-2b's head_dim; 141 KB of shared memory in
                        # float32, 193 KB in bfloat16


def _check(q, k, v):
    from .. import check_operands
    if q.device.type == "cuda" and q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_hopper takes float32 or bfloat16; "
                        f"got {q.dtype}")
    check_operands("flash_attention_hopper", {"q": (q, q.dtype),
                                              "k": (k, q.dtype),
                                              "v": (v, q.dtype)})
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes: q {tuple(q.shape)} must be (B, Sq, H, "
                         f"hd), k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"(B, Skv, KV, hd)")
    b, _, h, hd = q.shape
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} "
                         f"kv heads (H % KV must be 0)")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside [1, {MAX_HEAD_DIM}]")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch x heads {b * h} exceeds {_MAX_GRID_Y}")


def flash_attention_hopper(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's
    type.  Replaces ``repro.kernels.flash_attention.kernel.
    flash_attention_bhsd``; no sequence is padded to a block multiple."""
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    _check(q, k, v)
    (b, sq, h, hd), (skv, kv) = q.shape, k.shape[1:3]
    out = torch.empty_like(q)
    if out.numel() and skv:
        from .. import launch
        launch("repro_flash_attention", q.device, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, h, kv,
               hd, int(bool(causal)), int(window), float(softcap),
               _DTYPE_CODES[q.dtype])
        flash_attention_hopper.launches += 1
    return out


flash_attention_hopper.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of the wrapper in this module."""
    return {"flash_attention_hopper": flash_attention_hopper.launches}


def reset_launch_counts() -> None:
    flash_attention_hopper.launches = 0
