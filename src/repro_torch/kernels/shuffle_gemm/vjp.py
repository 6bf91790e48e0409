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

:class:`ShuffleGemmChainFn` is the same rule over a chain of grouped
sub-steps (``ops.ShuffleGemmChain``): its backward is itself a chain —
for s = S..1 the transposed GEMM on the identity gather, then the
adjoint reduction (folded into the next transposed GEMM's gather where
it is a permutation) — segmented and launched like the forward
(:func:`backward_chain`).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from ...core.fabric import ShufflePlan
from .kernel import shuffle_gemm_blocks, shuffle_gemm_grouped_blocks
from .ref import gather_rows
from .tiling import RowSpans

__all__ = ["ShuffleGemmFn", "ShuffleGemmChainFn", "VJP_CACHE_BACKEND",
           "adjoint_lowering", "backward_chain"]

# plan-cache label for adjoint (VJP) lowerings — apart from the forward
# backend name, so plan_cache_info()["by_backend"] accounts forward and
# backward lowerings independently.
VJP_CACHE_BACKEND = "hopper:vjp"


@functools.lru_cache(maxsize=64)
def _identity_blocks(rows: int, t: int, dtype, device: str):
    """Blocks of the identity gather over a flat ``(rows * t)`` stream —
    feeds each kernel row its own slice; routes the cotangent into the
    transposed GEMM — with their row-tile spans.  Built once per shape,
    type and device."""
    idx = torch.arange(rows * t, dtype=torch.int32,
                       device=device).reshape(rows, t)
    spans = RowSpans(np.arange(rows * t).reshape(rows, t))
    return idx, torch.zeros((rows, t), dtype=dtype, device=device), spans


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
    on ``device``: ``(idx, pads, scale, ones, spans)`` such that
    gathering the flat cotangent through ``(idx, pads, scale)`` (row-tile
    spans ``spans``) and contracting each of the ``n_in`` rows against
    ``ones`` (an ``(m, 1)`` operand) yields ``d_x`` — the two steps of
    :func:`repro_torch.core.exec_ir.adjoint_gather_steps`, lowered as
    the backend lowers any forward group.  Cached through the plan cache
    under :data:`VJP_CACHE_BACKEND`, so repeated ``value_and_grad``
    calls rebuild nothing."""
    from ...core.exec_ir import adjoint_gather_steps
    from ...signal import plan_cache_get
    from .ops import plan_blocks

    def build():
        gather, reduce_ = adjoint_gather_steps("vjp", plan, n_in, diag)
        _, idx, pads, scale, _, spans = plan_blocks(
            gather.plan, gather.diag, n_in, dtype, device)
        ones = torch.ones((reduce_.cin, 1), dtype=dtype, device=device)
        return idx, pads, scale, ones, spans

    key = (*_digest(plan, diag, n_in), str(torch.device(device)), dtype)
    return plan_cache_get("vjp_adjoint", key, build,
                          backend=VJP_CACHE_BACKEND)


def _adjoint_dx(dg_flat: torch.Tensor, plan: ShufflePlan, n_in: int,
                diag) -> torch.Tensor:
    """The cached adjoint lowering on a flat cotangent:
    ``(B, rows * t) -> (B, n_in)``."""
    aidx, apads, ascale, ones, spans = adjoint_lowering(
        plan, n_in, diag, dg_flat.dtype, dg_flat.device)
    return shuffle_gemm_blocks(dg_flat, aidx, apads, ones, ascale,
                               spans)[..., 0]


class ShuffleGemmFn(torch.autograd.Function):
    """A shuffle-GEMM kernel with its backward on the same kernels.
    ``xb``: (B, n_in); ``blocks`` is ``(t, idx, pads, scale, spans)`` of
    :func:`repro_torch.kernels.shuffle_gemm.ops.plan_blocks` for
    ``(plan, diag)``.  With ``dims`` None it runs
    ``shuffle_gemm_blocks``: ``w`` (t, n_out) -> (B, rows, n_out).  With
    ``dims = (reps, groups, nb)`` it runs ``shuffle_gemm_grouped_blocks``:
    ``w`` (groups, t, n_out) -> (B, rows * n_out), rows = reps * groups *
    nb.  The first is the second at ``(1, 1, rows)`` with one group."""

    @staticmethod
    def forward(ctx, xb, w, blocks, plan, diag, dims=None):
        t, idx, pads, scale, spans = blocks
        ctx.save_for_backward(xb, w)
        ctx.plan, ctx.diag, ctx.t, ctx.dims = plan, diag, t, dims
        ctx.idx, ctx.pads, ctx.scale = idx, pads, scale
        if dims is None:
            return shuffle_gemm_blocks(xb, idx, pads, w, scale, spans)
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
            iidx, ipads, ispans = _identity_blocks(rows, n_out, dy.dtype,
                                                   str(dy.device))
            if ctx.dims is None:
                dg = shuffle_gemm_blocks(dy, iidx, ipads, w.t().contiguous(),
                                         spans=ispans)
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


def backward_chain(chain, n_in: int):
    """The backward list of a forward chain read from a length-``n_in``
    input, as a chain: for each forward sub-step s, last first, the
    transposed GEMM (identity gather over its ``(rows, n_out)``
    cotangent, operand ``w[s]`` transposed to ``(groups, n_out, t)``)
    and the adjoint reduction (the gather of :func:`repro_torch.core.
    exec_ir.adjoint_gather_steps` over ``n_in_s`` rows of its ``m``
    slots, against an ``(m, 1)`` ones operand) — the two launches of
    :class:`ShuffleGemmFn`'s backward.  A reduction of width ``m = 1``
    (every source read once: a butterfly's permutation) is a gather and
    a multiply by 1, which the transposed GEMM after it absorbs: its
    identity gather becomes the adjoint gather (PAD slots and scale
    included).  fmaf(v, 1, 0) is v up to the sign of a zero, which no
    later sum can tell, so the values are bit for bit those of the list
    unfolded.  Segmented as any chain; cached under
    :data:`VJP_CACHE_BACKEND`.  Returns ``(chain, operands)``: per
    backward sub-step ``("w", s)`` (forward operand s, transposed) or
    ``("ones", m)``."""
    from ...core.exec_ir import adjoint_gather_steps
    from ...core.fabric import identity_plan
    from ...signal import plan_cache_get
    from .chain import SubStep
    from .ops import ShuffleGemmChain

    n_ins = [n_in] + [s.n_elems for s in chain.steps[:-1]]

    def build():
        steps, operands, pending = [], [], None
        for i in reversed(range(len(chain.steps))):
            s = chain.steps[i]
            plan, diag, name = identity_plan(s.rows * s.n_out), None, ""
            if pending is not None:
                plan, diag, name = pending.plan, pending.diag, \
                    pending.name + "+"
            steps.append(SubStep(f"{name}{s.name}.transpose", plan, diag,
                                 s.rows, s.t, s.groups, s.nb))
            operands.append(("w", i))
            gather, reduce_ = adjoint_gather_steps(s.name, s.plan, n_ins[i],
                                                   s.diag)
            pending = gather if reduce_.cin == 1 and i > 0 else None
            if pending is None:
                steps.append(SubStep(gather.name, gather.plan, gather.diag,
                                     n_ins[i], 1))
                operands.append(("ones", reduce_.cin))
        return ShuffleGemmChain(steps), tuple(operands)

    key = tuple((*_digest(s.plan, s.diag, k), s.rows, s.n_out, s.groups,
                 s.nb) for s, k in zip(chain.steps, n_ins))
    return plan_cache_get("vjp_chain", key, build, backend=VJP_CACHE_BACKEND)


@functools.lru_cache(maxsize=64)
def _ones(m: int, dtype, device: str) -> torch.Tensor:
    """The ``(1, m, 1)`` operand of an adjoint reduction."""
    return torch.ones((1, m, 1), dtype=dtype, device=device)


class ShuffleGemmChainFn(torch.autograd.Function):
    """A chain of grouped sub-steps (``ops.ShuffleGemmChain``) with its
    backward on the same kernels.  ``xb``: (B, n_in); ``ws[s]``: sub-step
    s's ``(groups, t, n_out)`` operand -> (B, rows * n_out of the last
    sub-step).

    Backward, where only ``xb`` needs a gradient: the
    :func:`backward_chain` list, run through the same segmentation and
    kernels on the cotangent (one launch a segment).  Where a ``w``
    needs one, its ``d_w`` is :class:`ShuffleGemmFn`'s einsum of the
    sub-step's gathered input against its output cotangent, and the
    chain kept neither: the backward recomputes them by replaying the
    chain one sub-step at a time through :class:`ShuffleGemmFn` under
    autograd (each sub-step's input from the one before, on the per-step
    kernels) and differentiating that.  On the card a chain launch is
    bit for bit its sub-steps launched one at a time, so both branches
    give the per-step path's gradients."""

    @staticmethod
    def forward(ctx, xb, chain, *ws):
        from .ops import run_segments
        ctx.chain = chain
        ctx.save_for_backward(xb, *ws)
        return run_segments(xb, chain.segments, ws)

    @staticmethod
    def backward(ctx, dy):
        from .ops import plan_blocks, run_segments
        xb, *ws = ctx.saved_tensors
        chain, need = ctx.chain, ctx.needs_input_grad
        if not any(need[2:]):
            back, operands = backward_chain(chain, xb.shape[1])
            bws = [ws[v].transpose(1, 2).contiguous() if kind == "w"
                   else _ones(v, dy.dtype, str(dy.device))
                   for kind, v in operands]
            dx = run_segments(dy.contiguous(), back.segments, bws)
            return (dx, None) + (None,) * len(ws)
        with torch.enable_grad():
            x = xb.detach().requires_grad_(need[0])
            wl = [w.detach().requires_grad_(n) for w, n in zip(ws, need[2:])]
            y = x
            for s, w in zip(chain.steps, wl):
                t, idx, pads, scale, _, spans = plan_blocks(
                    s.plan, s.diag, s.rows, y.dtype, y.device)
                y = ShuffleGemmFn.apply(y, w, (t, idx, pads, scale, spans),
                                        s.plan, s.diag,
                                        (s.reps, s.groups, s.nb))
            leaves = [v for v in (x, *wl) if v.requires_grad]
            grads = iter(torch.autograd.grad(y, leaves, dy))
        return ((next(grads) if need[0] else None, None)
                + tuple(next(grads) if n else None for n in need[2:]))
