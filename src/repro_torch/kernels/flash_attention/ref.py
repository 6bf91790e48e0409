"""Plain PyTorch version of the flash-attention kernel: the port's own
copy of the JAX package's direct (materialized-scores) attention and its
logit softcap (``repro.models.layers.direct_attention`` / ``_softcap``).

It materializes the ``(Sq, Skv)`` scores in float32; the wrapper in
``kernel.py`` runs it for tensors on the CPU, and the card-side tests and
``chip_smoke.py`` hold the CUDA kernel against it."""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "ref_attention"]

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
