"""Wrappers of the flash-attention CUDA kernels.

The kernels (``kernels/csrc/flash_attention.cu``) take the place of the
JAX package's Pallas TPU kernel ``flash_attention_bhsd``: online-softmax
attention with GQA (query head ``h`` reads kv head ``h // (H / KV)``),
causal and sliding-window masks, a tanh logit softcap and ragged tails,
float32 running state, output in the query's type.  They read the entry
point's ``(B, S, H, hd)`` layout directly.  Both types run on the tensor
cores: bfloat16 as ``wgmma`` on bfloat16 operands fed by TMA (P rounded
to bfloat16 before P V), float32 as ``wgmma`` on split-TF32 operands,
three TF32 products for each float32 one.  A float32 call is two
launches: :func:`flash_split_kv_hopper` writes K and V split (and V
transposed) as the attention body's tile images into scratch, then the
attention body runs on them; a bfloat16 call is one launch.

Each wrapper runs its plain PyTorch version (``ref.py``) for a tensor on
the CPU, and for a tensor on the card checks device, type, shape and
contiguity, allocates its output (and scratch) with ``torch.empty``,
launches on the current stream and raises if the launch reports an
error.  Each counts its launches in its ``launches`` attribute, a plain
integer incremented once per kernel launch and nowhere else.
"""

from __future__ import annotations

import torch

from .ref import f32_tiling, ref_attention, ref_split_kv

__all__ = ["flash_attention_hopper", "flash_split_kv_hopper",
           "launch_counts", "reset_launch_counts", "MAX_HEAD_DIM",
           "LAUNCHES_PER_CALL"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
MAX_HEAD_DIM = 256      # gemma2-2b's head_dim; 225 KB of shared memory in
                        # float32, 193 KB in bfloat16
# launches of one call on the card, by the query's type
LAUNCHES_PER_CALL = {torch.float32: {"flash_split_kv_hopper": 1,
                                     "flash_attention_hopper": 1},
                     torch.bfloat16: {"flash_attention_hopper": 1}}


def _check(q, k, v):
    from .. import check_operands
    if q.device.type == "cuda" and q.dtype not in _DTYPES:
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


def flash_split_kv_hopper(k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """k/v: (B, Skv, KV, hd) float32 -> (B, KV, tiles, 4, BK * D) float32
    scratch: each tile of BK keys as K big, K small, V^T big and V^T
    small (``ref.split_tf32``), laid out as the float32 attention body's
    shared-memory images (``ref.image_index``), the tiling
    ``ref.f32_tiling(hd)`` gives.  The float32 path's pre-pass; its plain
    version is ``ref.ref_split_kv``."""
    if k.device.type == "cpu":
        return ref_split_kv(k, v)
    from .. import check_operands, launch
    check_operands("flash_split_kv_hopper", {"k": (k, torch.float32),
                                             "v": (v, torch.float32)})
    if k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be one (B, Skv, KV, hd)")
    b, skv, kv, hd = k.shape
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside [1, {MAX_HEAD_DIM}]")
    if b * kv > _MAX_GRID_Y:
        raise ValueError(f"batch x kv heads {b * kv} exceeds {_MAX_GRID_Y}")
    d, bk = f32_tiling(hd)
    tiles = -(-skv // bk)
    blob = torch.empty((b, kv, tiles, 4, bk * d), dtype=torch.float32,
                       device=k.device)
    if blob.numel():
        launch("repro_flash_split_kv", k.device, k.data_ptr(), v.data_ptr(),
               blob.data_ptr(), b, skv, kv, hd, d, bk, tiles)
        flash_split_kv_hopper.launches += 1
    return blob


def flash_attention_hopper(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's
    type.  Replaces ``repro.kernels.flash_attention.kernel.
    flash_attention_bhsd``; no sequence is padded to a block multiple.
    float32 launches :func:`flash_split_kv_hopper`, then the split-TF32
    body; bfloat16 launches the bfloat16 body.

    The float32 body's error grows with the keys a query row sees: the
    tensor cores truncate as they accumulate O over a row's key tiles.
    ``tools/flash_error.py`` measures it against float64 by key count;
    PERF.md gives the readings."""
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    _check(q, k, v)
    (b, sq, h, hd), (skv, kv) = q.shape, k.shape[1:3]
    out = torch.empty_like(q)
    if out.numel() and skv:
        from .. import launch
        flags = (int(bool(causal)), int(window), float(softcap))
        if q.dtype == torch.float32:
            d, bk = f32_tiling(hd)
            blob = flash_split_kv_hopper(k, v)
            launch("repro_flash_attention_f32", q.device, q.data_ptr(),
                   blob.data_ptr(), out.data_ptr(), b, sq, skv, h, kv, hd,
                   d, bk, blob.shape[2], *flags)
        else:
            launch("repro_flash_attention", q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
                   h, kv, hd, *flags)
        flash_attention_hopper.launches += 1
    return out


flash_attention_hopper.launches = 0
flash_split_kv_hopper.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` of the wrappers in this module."""
    return {"flash_attention_hopper": flash_attention_hopper.launches,
            "flash_split_kv_hopper": flash_split_kv_hopper.launches}


def reset_launch_counts() -> None:
    flash_attention_hopper.launches = 0
    flash_split_kv_hopper.launches = 0
