"""Public wrappers: run a compiled ShufflePlan + GEMM through the fused
shuffle-GEMM kernels.  Accepts the same ShufflePlan objects as
core.fabric and the same arguments as the JAX package's ops (its
TPU-only ``br`` block size and ``interpret`` switch have no counterpart:
the CUDA kernel masks its ragged edge, and the tensor's device picks the
kernel or the plain version).

Both ops are differentiable in ``x`` and ``w``: they run through the
``torch.autograd.Function`` of ``vjp.py``, whose backward pass
launches the same kernels on adjoint operands.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.fabric import PAD, ShufflePlan, device_constant
from .vjp import ShuffleGemmFn

__all__ = ["plan_blocks", "shuffle_gemm", "shuffle_gemm_grouped"]


def plan_blocks(plan: ShufflePlan, diag, rows: int, dtype, device):
    """A flat plan (+ optional diag scale) as the kernels' ``(rows, t)``
    row-major blocks on ``device``: ``(t, idx, pads, scale, max_index)``
    with ``idx`` int32, ``pads``/``scale`` in ``dtype`` (``scale`` None
    without a diag) and ``max_index`` the largest source index read.
    Built once per (rows, device, dtype, diag) and kept on the plan."""
    if rows <= 0 or plan.n_out % rows:
        raise ValueError(f"plan of {plan.n_out} elements does not split "
                         f"into {rows} rows")
    t = plan.n_out // rows
    cache = plan.__dict__.setdefault("_kernel_blocks", {})
    key = (rows, str(torch.device(device)), dtype, id(diag))
    hit = cache.get(key)
    if hit is not None and hit[0] is diag:
        return hit[1]
    gi = plan.gather_idx
    if bool((gi < PAD).any()):
        raise ValueError("plan holds negative indices other than PAD")
    idx = torch.as_tensor(gi.reshape(rows, t), device=device)
    pads = torch.as_tensor(np.asarray(plan.pad_values).reshape(rows, t),
                           device=device).to(dtype)
    scale = None if diag is None else torch.as_tensor(
        np.asarray(diag).reshape(rows, t), device=device).to(dtype)
    blocks = (t, idx.contiguous(), pads.contiguous(),
              None if scale is None else scale.contiguous(),
              int(gi.max()) if gi.size else -1)
    cache[key] = (diag, blocks)
    return blocks


def _prepare(x: torch.Tensor, plan, diag, rows, w):
    t, idx, pads, scale, max_index = plan_blocks(plan, diag, rows, x.dtype,
                                                 x.device)
    n_in = x.shape[-1]
    if max_index >= n_in:
        raise ValueError(f"plan reads index {max_index} of a length-{n_in} "
                         f"input")
    xb = x.reshape(-1, n_in).contiguous()
    w = device_constant(w, x.device, x.dtype).contiguous()
    return xb, (t, idx, pads, scale), w


def shuffle_gemm(x: torch.Tensor, plan: ShufflePlan, w, rows: int,
                 diag=None) -> torch.Tensor:
    """out = reshape(apply_plan(x) (* diag), (rows, t)) @ w, fused in one
    kernel.

    x: (..., n_in); plan.n_out == rows * t; w: (t, n_out); diag is an
    optional per-element scale of the gathered stream (a GatherStep /
    EinsumStep ``diag``).  Returns (..., rows, n_out).  Differentiable
    in ``x`` and ``w``.
    """
    xb, blocks, w = _prepare(x, plan, diag, rows, w)
    out = ShuffleGemmFn.apply(xb, w, blocks, plan, diag)
    return out.reshape(*x.shape[:-1], rows, w.shape[-1])


def shuffle_gemm_grouped(x: torch.Tensor, plan: ShufflePlan, w,
                         reps: int, groups: int, nb: int,
                         diag=None) -> torch.Tensor:
    """Grouped-operand variant: plan rows have flat layout
    ``(reps, groups, nb)`` and row ``r`` contracts against
    ``w[(r // nb) % groups]`` — the FFT-butterfly shape (per-twiddle-class
    matmuls) behind an arbitrary fused gather plan.

    x: (..., n_in); plan.n_out == reps * groups * nb * t;
    w: (groups, t, n_out).  Returns the flat (..., R * n_out) result in
    row order (the consuming einsum's natural layout).  Differentiable in
    ``x`` and ``w``.
    """
    rows = reps * groups * nb
    xb, blocks, w = _prepare(x, plan, diag, rows, w)
    out = ShuffleGemmFn.apply(xb, w, blocks, plan, diag, (reps, groups, nb))
    return out.reshape(*x.shape[:-1], rows * w.shape[-1])
