"""Wrappers of the fused shuffling-fabric + GEMM CUDA kernels.

The kernels (``kernels/csrc/shuffle_gemm.cu``) take the place of the JAX
package's Pallas TPU kernels of the same names:

    out[b, r, :] = (x[b, idx[r, :]] | pad) (* scale) @ w

  * :func:`shuffle_gemm_blocks` — one shared ``(t, n_out)`` operand for
    every row (FIR taps, DCT matrix, mel filterbank).
  * :func:`shuffle_gemm_grouped_blocks` — a *grouped* operand
    ``(G, t, n_out)``: row ``r`` (flat layout ``(reps, G, nb)``)
    contracts against group ``(r // nb) % G`` — the FFT butterfly shape.

Each wrapper runs the plain PyTorch version (``ref.py``) for a tensor on
the CPU, and for a tensor on the card checks device, type, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch reports an error.  It counts its
launches in its ``launches`` attribute, a plain integer incremented once
per kernel launch and nowhere else.

Indices must lie in ``[-1, n_in)`` (-1 = PAD); the kernel does not
bounds-check them.  ``ops.py`` validates every plan once before its
first launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ref import ref_shuffle_gemm_blocks, ref_shuffle_gemm_grouped_blocks

__all__ = ["shuffle_gemm_blocks", "shuffle_gemm_grouped_blocks",
           "launch_counts", "reset_launch_counts"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _check(x, idx, pad_vals, w, scale, w_rank):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"shuffle_gemm kernels run on CUDA tensors or "
                         f"(plain version) CPU tensors; got {dev}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"shuffle_gemm kernels take float32 or bfloat16; "
                        f"got {x.dtype}")
    tensors = {"x": x, "idx": idx, "pad_vals": pad_vals, "w": w}
    if scale is not None:
        tensors["scale"] = scale
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.int32 if name == "idx" else x.dtype
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}; got {t.dtype}")
    if x.ndim != 2 or idx.ndim != 2 or w.ndim != w_rank:
        raise ValueError(f"shapes: x {tuple(x.shape)} must be (B, n_in), "
                         f"idx {tuple(idx.shape)} (R, t), w "
                         f"{tuple(w.shape)} rank {w_rank}")
    if pad_vals.shape != idx.shape or (scale is not None
                                       and scale.shape != idx.shape):
        raise ValueError("pad_vals / scale must match idx's (R, t) shape")
    if w.shape[-2] != idx.shape[1]:
        raise ValueError(f"w contracts over {w.shape[-2]}, rows hold "
                         f"{idx.shape[1]} elements")
    if x.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"batch {x.shape[0]} exceeds {_MAX_GRID_Y}")


def _launch(fn, x, idx, pad_vals, w, scale, out, *ints):
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), idx.data_ptr(), pad_vals.data_ptr(),
                 None if scale is None else scale.data_ptr(), w.data_ptr(),
                 out.data_ptr(), *ints, _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def shuffle_gemm_blocks(x: torch.Tensor, idx: torch.Tensor,
                        pad_vals: torch.Tensor, w: torch.Tensor,
                        scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """x: (B, n_in); idx/pad_vals[/scale]: (R, t); w: (t, n_out) ->
    (B, R, n_out).  Replaces ``repro.kernels.shuffle_gemm.kernel.
    shuffle_gemm_blocks``; rows need no padding to a block multiple."""
    if x.device.type == "cpu":
        return ref_shuffle_gemm_blocks(x, idx, pad_vals, w, scale)
    _check(x, idx, pad_vals, w, scale, w_rank=2)
    (b, n_in), (r, t), n_out = x.shape, idx.shape, w.shape[-1]
    out = torch.empty((b, r, n_out), dtype=x.dtype, device=x.device)
    if out.numel():
        from .. import library
        _launch(library().repro_shuffle_gemm_blocks,
                x, idx, pad_vals, w, scale, out, b, n_in, r, t, n_out)
        shuffle_gemm_blocks.launches += 1
    return out


def shuffle_gemm_grouped_blocks(x: torch.Tensor, idx: torch.Tensor,
                                pad_vals: torch.Tensor, w: torch.Tensor,
                                reps: int, groups: int, nb: int,
                                scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """x: (B, n_in); idx/pad_vals[/scale]: (R, t) with R = reps*G*nb in
    (reps, G, nb) row order; w: (G, t, n_out) -> (B, R * n_out) flat in
    the same row order.  Replaces ``repro.kernels.shuffle_gemm.kernel.
    shuffle_gemm_grouped_blocks``."""
    if x.device.type == "cpu":
        return ref_shuffle_gemm_grouped_blocks(x, idx, pad_vals, w, reps,
                                               groups, nb, scale)
    _check(x, idx, pad_vals, w, scale, w_rank=3)
    (b, n_in), (r, t), n_out = x.shape, idx.shape, w.shape[-1]
    if r != reps * groups * nb or w.shape[0] != groups:
        raise ValueError(f"R={r} must equal reps*groups*nb="
                         f"{reps * groups * nb} and w must hold {groups} "
                         f"groups (has {w.shape[0]})")
    out = torch.empty((b, r * n_out), dtype=x.dtype, device=x.device)
    if out.numel():
        from .. import library
        _launch(library().repro_shuffle_gemm_grouped_blocks,
                x, idx, pad_vals, w, scale, out, b, n_in, reps, groups, nb,
                t, n_out)
        shuffle_gemm_grouped_blocks.launches += 1
    return out


shuffle_gemm_blocks.launches = 0
shuffle_gemm_grouped_blocks.launches = 0
_WRAPPERS = (shuffle_gemm_blocks, shuffle_gemm_grouped_blocks)


def launch_counts() -> dict:
    """``{kernel name: launches}`` of every wrapper in this module."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
