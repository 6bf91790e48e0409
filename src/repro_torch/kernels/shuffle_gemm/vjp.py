"""Reverse-mode rules for the fused shuffle-GEMM kernels.

The counterpart of the JAX package's ``kernels/shuffle_gemm/vjp.py``,
as one :class:`torch.autograd.Function` over both kernels.  The forward op is one
gather∘einsum group: ``out = reshape(gather(x) (* diag), (rows, t)) @
w``.  Its transpose is *another* gather∘einsum group — the fabric is its
own adjoint — so the backward pass launches the same two kernels on
adjoint operands:

  * ``d_gathered = d_out @ w.T`` — the transposed GEMM, fed by the
    *identity* gather (each output row streams its own cotangent row);
    the grouped kernel takes each group's operand transposed;
  * ``d_x`` — scatter-as-gather of the inverse index map
    (:func:`repro_torch.core.fabric.adjoint_plan`): gather the (up to
    ``m``) forward positions reading each source element, scale by the
    forward ``diag`` en route, and reduce the ``m`` slots on the array
    against an ``(m, 1)`` ones operand — a width-``m`` GEMM on
    :func:`shuffle_gemm_blocks`;
  * ``d_w = einsum('brt,bro->to', gather(x) * diag, d_out)`` — the
    gathered activations against the cotangent, a dense product the
    JAX package leaves to XLA and this port to ``torch.einsum``.

``d_x`` and ``d_w`` are computed only where ``ctx.needs_input_grad``
asks for them (the JAX package computes both; the results are the
same).  On the CPU the kernel wrappers run their plain versions, so the
same backward runs there.

The adjoint lowering (inverse plan blocks + reduction operand) is built
from the two-step program of
:func:`repro_torch.core.exec_ir.adjoint_gather_steps` and cached per
device through the signal package's plan cache under the
``"hopper:vjp"`` label, apart from the forward ``"hopper"`` lowerings.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from ...core.fabric import ShufflePlan
from .kernel import shuffle_gemm_blocks, shuffle_gemm_grouped_blocks
from .ref import gather_rows

__all__ = ["ShuffleGemmFn", "VJP_CACHE_BACKEND", "adjoint_lowering"]

# plan-cache label for adjoint (VJP) lowerings — apart from the forward
# backend name, so plan_cache_info()["by_backend"] accounts forward and
# backward lowerings independently.
VJP_CACHE_BACKEND = "hopper:vjp"


@functools.lru_cache(maxsize=64)
def _identity_blocks(rows: int, t: int, dtype, device: str):
    """Blocks of the identity gather over a flat ``(rows * t)`` stream —
    feeds each kernel row its own slice; routes the cotangent into the
    transposed GEMM.  Built once per shape, type and device."""
    idx = torch.arange(rows * t, dtype=torch.int32,
                       device=device).reshape(rows, t)
    return idx, torch.zeros((rows, t), dtype=dtype, device=device)


def _digest(plan: ShufflePlan, diag, n_in: int) -> tuple:
    """Content key of one forward gather's adjoint, computed once per
    (plan, diag, n_in) and kept on the plan."""
    memo = plan.__dict__.setdefault("_vjp_digest", {})
    key = (id(diag), n_in)
    hit = memo.get(key)
    if hit is not None and hit[0] is diag:
        return hit[1]
    h = hashlib.sha1()
    for arr in (plan.gather_idx, plan.pad_values,
                np.zeros(0) if diag is None else np.asarray(diag)):
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    digest = (h.hexdigest(), n_in)
    memo[key] = (diag, digest)
    return digest


def adjoint_lowering(plan: ShufflePlan, n_in: int, diag, dtype, device):
    """Kernel-ready blocks of the adjoint program of one forward gather
    on ``device``: ``(idx, pads, scale, ones)`` such that gathering the
    flat cotangent through ``(idx, pads, scale)`` and contracting each
    of the ``n_in`` rows against ``ones`` (an ``(m, 1)`` operand) yields
    ``d_x`` — the two steps of
    :func:`repro_torch.core.exec_ir.adjoint_gather_steps`, lowered as
    the backend lowers any forward group.  Cached through the plan cache
    under :data:`VJP_CACHE_BACKEND`, so repeated ``value_and_grad``
    calls rebuild nothing."""
    from ...core.exec_ir import adjoint_gather_steps
    from ...signal import plan_cache_get
    from .ops import plan_blocks

    def build():
        gather, reduce_ = adjoint_gather_steps("vjp", plan, n_in, diag)
        _, idx, pads, scale, _ = plan_blocks(gather.plan, gather.diag,
                                             n_in, dtype, device)
        ones = torch.ones((reduce_.cin, 1), dtype=dtype, device=device)
        return idx, pads, scale, ones

    key = (*_digest(plan, diag, n_in), str(torch.device(device)), dtype)
    return plan_cache_get("vjp_adjoint", key, build,
                          backend=VJP_CACHE_BACKEND)


def _adjoint_dx(dg_flat: torch.Tensor, plan: ShufflePlan, n_in: int,
                diag) -> torch.Tensor:
    """The cached adjoint lowering on a flat cotangent:
    ``(B, rows * t) -> (B, n_in)``."""
    aidx, apads, ascale, ones = adjoint_lowering(plan, n_in, diag,
                                                 dg_flat.dtype,
                                                 dg_flat.device)
    return shuffle_gemm_blocks(dg_flat, aidx, apads, ones, ascale)[..., 0]


class ShuffleGemmFn(torch.autograd.Function):
    """A shuffle-GEMM kernel with its backward on the same kernels.
    ``xb``: (B, n_in); ``blocks`` is ``(t, idx, pads, scale)`` of
    :func:`repro_torch.kernels.shuffle_gemm.ops.plan_blocks` for
    ``(plan, diag)``.  With ``dims`` None it runs
    ``shuffle_gemm_blocks``: ``w`` (t, n_out) -> (B, rows, n_out).  With
    ``dims = (reps, groups, nb)`` it runs ``shuffle_gemm_grouped_blocks``:
    ``w`` (groups, t, n_out) -> (B, rows * n_out), rows = reps * groups *
    nb.  The first is the second at ``(1, 1, rows)`` with one group."""

    @staticmethod
    def forward(ctx, xb, w, blocks, plan, diag, dims=None):
        t, idx, pads, scale = blocks
        ctx.save_for_backward(xb, w)
        ctx.plan, ctx.diag, ctx.t, ctx.dims = plan, diag, t, dims
        ctx.idx, ctx.pads, ctx.scale = idx, pads, scale
        if dims is None:
            return shuffle_gemm_blocks(xb, idx, pads, w, scale)
        return shuffle_gemm_grouped_blocks(xb, idx, pads, w, *dims, scale)

    @staticmethod
    def backward(ctx, dy):
        xb, w = ctx.saved_tensors
        b, n_in = xb.shape
        rows, t, n_out = ctx.idx.shape[0], ctx.t, w.shape[-1]
        reps, groups, nb = ctx.dims or (1, 1, rows)
        dy = dy.reshape(b, rows * n_out).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the transposed GEMM: identity gather, each group's operand
            # transposed; row r of the result holds dg[r, :] (length t),
            # the plan-flat layout.
            iidx, ipads = _identity_blocks(rows, n_out, dy.dtype,
                                            str(dy.device))
            if ctx.dims is None:
                dg = shuffle_gemm_blocks(dy, iidx, ipads, w.t().contiguous())
            else:
                dg = shuffle_gemm_grouped_blocks(
                    dy, iidx, ipads, w.transpose(1, 2).contiguous(), reps,
                    groups, nb)
            dx = _adjoint_dx(dg.reshape(b, rows * t), ctx.plan, n_in,
                             ctx.diag)
        if ctx.needs_input_grad[1]:
            g = gather_rows(xb, ctx.idx, ctx.pads, ctx.scale)
            dw = torch.einsum("brgnt,brgno->gto",
                              g.reshape(b, reps, groups, nb, t),
                              dy.reshape(b, reps, groups, nb, n_out).float())
            dw = dw.to(w.dtype).reshape(w.shape)
        return dx, dw, None, None, None, None
