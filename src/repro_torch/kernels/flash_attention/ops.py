"""Public wrapper: (B, S, H, hd) / (B, S, KV, hd) GQA attention through
the flash-attention kernel — the counterpart of the JAX package's
``repro.kernels.flash_attention``.  Its TPU block sizes ``bq``/``bk`` and
its ``interpret`` switch have no counterpart: the CUDA kernel tiles for
the SM and masks its ragged edges, and the tensor's device picks the
kernel or the plain version.  Forward only, as in the JAX package.

On the card the wrapper calls the custom op ``repro_torch::flash_attention``
(``torch.ops.repro_torch.flash_attention``), whose implementation is
:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention_hopper`
on either device (on the CPU, its plain version: what
``torch.library.opcheck`` runs), and whose fake implementation is an
``empty_like(q)``, so a trace on fake CUDA tensors (the dry-run,
``launch/dryrun.py``) goes through the card's own route, launching
nothing.  The op's flop formula, registered with
``torch.utils.flop_counter``, is :func:`flash_flops`."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .. import forward_only
from .kernel import flash_attention_hopper

__all__ = ["flash_attention", "flash_attention_op", "visible_pairs",
           "flash_flops"]


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types=("cuda", "cpu"))
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int,
                       softcap: float) -> torch.Tensor:
    """The flash kernel as a custom op: :func:`flash_attention_hopper`,
    on the card one launch (bfloat16; float32 adds its pre-pass),
    counted there."""
    return flash_attention_hopper(q, k, v, causal, window, softcap)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, softcap):
    return torch.empty_like(q)


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs a call's mask lets through: query ``i`` sees
    keys ``<= i`` when ``causal`` and keys ``> i - window`` when
    ``window > 0``."""
    qi = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qi + 1, skv) if causal else np.full(sq, skv, np.int64)
    lo = (np.maximum(qi - window + 1, 0) if window and window > 0
          else np.zeros(sq, np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, causal, window, softcap, *,
                out_shape=None, **kwargs) -> int:
    """4 B H hd per visible (query, key) pair: Q K^T and P V, a multiply
    and an add each."""
    b, sq, h, hd = q_shape
    return 4 * b * h * hd * visible_pairs(sq, k_shape[1], causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd).

    GQA is handled inside the kernel (query head h reads kv head
    h // (H / KV)); K and V are never expanded.  ``window > 0`` keeps the
    keys ``k > q - window``; ``softcap > 0`` caps the logits with
    ``softcap * tanh(s / softcap)``.  CPU tensors go straight to
    :func:`flash_attention_hopper`'s plain version, which differentiates
    (the op has no autograd); CUDA tensors through the custom op
    ``repro_torch::flash_attention`` (module docstring)."""
    forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_hopper(q, k, v, causal, window, softcap)
    return flash_attention_op(q.contiguous(), k.contiguous(), v.contiguous(),
                              bool(causal), int(window), float(softcap))
