"""Plain PyTorch versions of the flash-attention kernels.

:func:`ref_attention` is the port's own copy of the JAX package's direct
(materialized-scores) attention and its logit softcap
(``repro.models.layers.direct_attention`` / ``_softcap``).  It
materializes the ``(Sq, Skv)`` scores in float32; the wrapper in
``kernel.py`` runs it for tensors on the CPU, and the card-side tests and
``chip_smoke.py`` hold the CUDA kernel against it.

:func:`ref_split_kv` is the float32 path's pre-pass: K and V, each value
split into its nearest TF32 ``big`` and the TF32 ``small`` of the rest,
laid out tile by tile as the shared-memory images the attention body of
``csrc/flash_attention.cu`` reads (:func:`f32_tiling` gives the tiles).
The card tests hold the pre-pass kernel to it bit for bit, and the CPU
tests decode its images to check the layout."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["NEG_INF", "ref_attention", "f32_tiling", "tf32_rna",
           "split_tf32", "image_index", "ref_split_kv"]

NEG_INF = -1e30


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd), H % KV == 0 (query head
    h reads kv head h // (H / KV)) -> (B, Sq, H, hd) in q's type."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    scores = _softcap(scores, softcap)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window and window > 0:
        mask &= ki > qi - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


# Padded head dim D -> keys a tile: the float32 body's Shape<D> in
# csrc/flash_attention.cu, which refuses any other pair.  Its C query
# repro_flash_f32_tiling gives the kernel's side; a card test holds the two
# equal for every head dim.
_F32_KEYS = {64: 64, 128: 32, 256: 16}


def f32_tiling(hd: int) -> tuple:
    """``(D, BK)`` of the float32 body for head dim ``hd`` (1..256): the
    head dim padded to 64, 128 or 256 and the keys a tile."""
    d = 64 if hd <= 64 else 128 if hd <= 128 else 256
    return d, _F32_KEYS[d]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to its nearest TF32 value (10-bit mantissa),
    ties away from zero, as PTX ``cvt.rna.tf32.f32``: half a unit of the
    13 dropped bits added to the magnitude's bit pattern, then cut."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32).reshape(x.shape)


def split_tf32(x: torch.Tensor) -> tuple:
    """``(big, small)``: ``big = tf32(x)``, ``small = tf32(x - big)``."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


@functools.lru_cache(maxsize=8)
def image_index(d: int, bk: int) -> tuple:
    """Where the float32 body's tile images take their values, as flat
    indices into a ``(bk, d)`` tile (key-major): ``(k_src, v_src)``, int64
    arrays of ``bk * d``.  Element ``e`` of the K image is tile element
    ``k_src[e]``: ``bk`` rows of ``d`` floats as 32-column chunks of
    128-byte rows in the 128-byte swizzle (16-byte unit ``c / 4`` XOR row
    % 8).  The V^T image holds ``d`` rows of ``bk`` keys, the keys of each
    group of 8 in the order [0, 2, 4, 6, 1, 3, 5, 7]: 32-key chunks in
    the same swizzle, or for ``bk`` 16, 64-byte rows in the 64-byte
    swizzle (unit XOR (row / 2) % 4)."""
    e = np.arange(bk * d)

    def unswizzle128(rows):
        chunk, rem = e // (rows * 32), e % (rows * 32)
        r = rem >> 5
        return r, chunk * 32 + ((((rem >> 2) & 7) ^ (r & 7)) << 2) + (e & 3)

    r, c = unswizzle128(bk)
    k_src = r * d + c
    if bk < 32:
        r = e >> 4
        c = ((((e >> 2) & 3) ^ ((r >> 1) & 3)) << 2) + (e & 3)
    else:
        r, c = unswizzle128(d)
    w = c & 7
    key = (c & ~7) | np.where(w < 4, 2 * w, 2 * w - 7)
    return k_src, key * d + r


@functools.lru_cache(maxsize=8)
def _image_index_on(d: int, bk: int, device: str) -> tuple:
    """:func:`image_index` as tensors on ``device``, made once, so a call
    under CUDA-graph capture copies nothing from the host."""
    return tuple(torch.as_tensor(i, device=device)
                 for i in image_index(d, bk))


def ref_split_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """k/v (B, Skv, KV, hd) float32 -> (B, KV, tiles, 4, BK * D) float32:
    each tile of BK keys (zero past ``Skv`` and past ``hd``) as K big, K
    small, V^T big and V^T small in the images :func:`image_index`
    describes, the tiling :func:`f32_tiling` gives."""
    b, skv, kv, hd = k.shape
    d, bk = f32_tiling(hd)
    tiles = -(-skv // bk)

    def tiled(x):               # (B, KV, tiles, BK * D), key-major tiles
        x = torch.nn.functional.pad(x.float(), (0, d - hd, 0, 0, 0,
                                                tiles * bk - skv))
        return x.reshape(b, tiles, bk, kv, d).permute(0, 3, 1, 2, 4) \
            .reshape(b, kv, tiles, bk * d)

    k_src, v_src = _image_index_on(d, bk, str(k.device))
    kb, ks = split_tf32(tiled(k)[..., k_src])
    vb, vs = split_tf32(tiled(v)[..., v_src])
    return torch.stack([kb, ks, vb, vs], dim=3).contiguous()
