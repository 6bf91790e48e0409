"""Plain PyTorch versions of the phased FIR kernel.

:func:`ref_fir_conv_hopper` is the kernel's function on the kernel's
arguments (window gather with PAD read as 0, then the tap-bank product,
accumulated in float32); the wrapper in ``kernel.py`` runs it for
tensors on the CPU, and the card-side tests and ``chip_smoke.py`` hold
the kernel against it.  :func:`ref_fir` is the JAX package's oracle, the
direct causal convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ref_fir_conv_hopper", "ref_fir"]


def ref_fir_conv_hopper(x: torch.Tensor, idx: torch.Tensor,
                        wbank: torch.Tensor) -> torch.Tensor:
    """x (B, n); idx (M, L) with PAD = -1; wbank (L, P) -> (B, M * P)."""
    win = x[:, idx.clamp(min=0).long()]                  # (B, M, L)
    win = torch.where(idx < 0, torch.zeros((), dtype=win.dtype,
                                           device=win.device), win)
    return torch.matmul(win, wbank).reshape(x.shape[0], -1)


def ref_fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Direct causal convolution: ``convolve(x, h)[..., :n]``."""
    n, taps = x.shape[-1], h.shape[-1]
    xp = F.pad(x, (taps - 1, 0))
    win = torch.stack([xp[..., i:i + n] for i in range(taps)], dim=-1)
    return torch.einsum("...nt,t->...n", win, h.flip(-1).to(x.dtype))
