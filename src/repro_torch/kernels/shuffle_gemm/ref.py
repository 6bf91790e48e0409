"""Plain PyTorch versions of the shuffle-GEMM kernels.

The same function as the CUDA kernels, with the same arithmetic: gather,
PAD fill and scale in float32, contraction accumulated in float32, result
stored in the input type.  The wrappers in ``kernel.py`` run these for
tensors on the CPU; the card-side tests and ``chip_smoke.py`` hold the
kernels against them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.fabric import ShufflePlan, apply_plan, device_constant


def gather_rows(x: torch.Tensor, idx: torch.Tensor, pad_vals: torch.Tensor,
                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``(B, n_in)`` -> the float32 ``(B, R, t)`` operand rows:
    ``where(idx < 0, pad, x[:, idx]) * scale``."""
    g = x[:, idx.clamp(min=0).long()]
    g = torch.where(idx < 0, pad_vals.to(g.dtype), g).float()
    if scale is not None:
        g = g * scale.float()
    return g


def ref_shuffle_gemm_blocks(x: torch.Tensor, idx: torch.Tensor,
                            pad_vals: torch.Tensor, w: torch.Tensor,
                            scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """x (B, n_in); idx/pad_vals[/scale] (R, t); w (t, n_out) ->
    (B, R, n_out)."""
    g = gather_rows(x, idx, pad_vals, scale)
    return torch.matmul(g, w.float()).to(x.dtype)


def ref_shuffle_gemm_grouped_blocks(x: torch.Tensor, idx: torch.Tensor,
                                    pad_vals: torch.Tensor, w: torch.Tensor,
                                    reps: int, groups: int, nb: int,
                                    scale: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """Rows in flat ``(reps, groups, nb)`` order; row r contracts against
    ``w[(r // nb) % groups]``.  w (groups, t, n_out) -> (B, R * n_out)."""
    g = gather_rows(x, idx, pad_vals, scale)
    b, _, t = g.shape
    g = g.reshape(b, reps, groups, nb, t)
    y = torch.einsum("brgnt,gto->brgno", g, w.float())
    return y.reshape(b, -1).to(x.dtype)


def ref_shuffle_gemm(x: torch.Tensor, plan: ShufflePlan, w: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """Unfused oracle: :func:`apply_plan` then a matmul."""
    s = apply_plan(x, plan)
    s = s.reshape(*x.shape[:-1], rows, plan.n_out // rows)
    return torch.matmul(s, device_constant(w, s.device, s.dtype))
