"""Public wrapper: (B, S, H, hd) / (B, S, KV, hd) GQA attention through
the flash-attention kernel — the counterpart of the JAX package's
``repro.kernels.flash_attention``.  Its TPU block sizes ``bq``/``bk`` and
its ``interpret`` switch have no counterpart: the CUDA kernel tiles for
the SM and masks its ragged edges, and the tensor's device picks the
kernel or the plain version.  Forward only, as in the JAX package."""

from __future__ import annotations

import torch

from .. import forward_only
from .kernel import flash_attention_hopper

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd).

    GQA is handled inside the kernel (query head h reads kv head
    h // (H / KV)); K and V are never expanded.  ``window > 0`` keeps the
    keys ``k > q - window``; ``softcap > 0`` caps the logits with
    ``softcap * tanh(s / softcap)``."""
    forward_only("flash_attention", q, k, v)
    return flash_attention_hopper(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal, window, softcap)
