"""Public wrappers: run a compiled ShufflePlan + GEMM through the fused
shuffle-GEMM kernels.  Accepts the same ShufflePlan objects as
core.fabric and the same arguments as the JAX package's ops (its
TPU-only ``br`` block size and ``interpret`` switch have no counterpart:
the CUDA kernel masks its ragged edge, and the tensor's device picks the
kernel or the plain version).

Both ops are differentiable in ``x`` and ``w``: they run through the
``torch.autograd.Function`` of ``vjp.py``, whose backward pass
launches the same kernels on adjoint operands.

:class:`ShuffleGemmChain` and :func:`run_chain` run a list of grouped
steps, each gathering from the one before (a stage's butterflies), as
the segments ``chain.py`` finds, one launch a segment; differentiable
through ``vjp.ShuffleGemmChainFn``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.fabric import PAD, ShufflePlan, device_constant
from .chain import segment_chain
from .tiling import RowSpans
from .kernel import (shuffle_gemm_blocks, shuffle_gemm_chain,
                     shuffle_gemm_grouped_blocks)
from .vjp import ShuffleGemmChainFn, ShuffleGemmFn

__all__ = ["plan_blocks", "shuffle_gemm", "shuffle_gemm_grouped",
           "ShuffleGemmChain", "run_chain", "run_segments"]


def plan_blocks(plan: ShufflePlan, diag, rows: int, dtype, device):
    """A flat plan (+ optional diag scale) as the kernels' ``(rows, t)``
    row-major blocks on ``device``: ``(t, idx, pads, scale, max_index,
    spans)`` with ``idx`` int32, ``pads``/``scale`` in ``dtype``
    (``scale`` None without a diag), ``max_index`` the largest source
    index read and ``spans`` the table's row-tile spans
    (:class:`~repro_torch.kernels.shuffle_gemm.tiling.RowSpans`, from the
    numpy plan).  Built once per (rows, device, dtype, diag) and kept on
    the plan."""
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
              int(gi.max()) if gi.size else -1,
              RowSpans(gi.reshape(rows, t),
                       np.asarray(plan.pad_values).reshape(rows, t),
                       None if diag is None else
                       np.asarray(diag).reshape(rows, t)))
    cache[key] = (diag, blocks)
    return blocks


def _prepare(x: torch.Tensor, plan, diag, rows, w):
    t, idx, pads, scale, max_index, spans = plan_blocks(plan, diag, rows,
                                                        x.dtype, x.device)
    n_in = x.shape[-1]
    if max_index >= n_in:
        raise ValueError(f"plan reads index {max_index} of a length-{n_in} "
                         f"input")
    xb = x.reshape(-1, n_in).contiguous()
    w = device_constant(w, x.device, x.dtype).contiguous()
    return xb, (t, idx, pads, scale, spans), w


def _per_row(x: torch.Tensor, plan, diag, rows: int, w):
    """Check a per-row call (``w`` one operand a batch row of ``x`` (B,
    n_in)) — a forward only where autograd would have to see through it —
    and return the plan's blocks (:func:`plan_blocks`)."""
    if x.ndim != 2 or x.shape[0] != w.shape[0]:
        raise ValueError(f"per-row w {tuple(w.shape)} needs x (B, n_in) "
                         f"with B = {w.shape[0]}; got {tuple(x.shape)}")
    from .. import forward_only
    forward_only("per-row shuffle-GEMM", x, w)
    blocks = plan_blocks(plan, diag, rows, x.dtype, x.device)
    if blocks[4] >= x.shape[-1]:
        raise ValueError(f"plan reads index {blocks[4]} of a "
                         f"length-{x.shape[-1]} input")
    return blocks


def shuffle_gemm(x: torch.Tensor, plan: ShufflePlan, w, rows: int,
                 diag=None) -> torch.Tensor:
    """out = reshape(apply_plan(x) (* diag), (rows, t)) @ w, fused in one
    kernel.

    x: (..., n_in); plan.n_out == rows * t; w: (t, n_out); diag is an
    optional per-element scale of the gathered stream (a GatherStep /
    EinsumStep ``diag``).  Returns (..., rows, n_out).  Differentiable
    in ``x`` and ``w``.

    With ``w`` of shape (B, t, n_out) and ``x`` of shape (B, n_in), row b
    contracts against ``w[b]`` (the serving path's per-row params): one
    launch of :func:`shuffle_gemm_blocks`, a forward only.  On the card
    it raises where autograd would have to see through it (as the JAX
    package's per-row path is a jitted forward); on the CPU the plain
    version differentiates.
    """
    if np.ndim(w) == 3:
        t, idx, pads, scale = _per_row(x, plan, diag, rows, w)[:4]
        w = device_constant(w, x.device, x.dtype).contiguous()
        return shuffle_gemm_blocks(x.contiguous(), idx, pads, w, scale)
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

    With ``w`` of shape (B, groups, t, n_out) and ``x`` of shape (B, n_in),
    row b contracts against ``w[b]`` (the serving path's per-row params):
    one launch of :func:`shuffle_gemm_grouped_blocks`, a forward only, as
    :func:`shuffle_gemm`'s per-row form.
    """
    rows = reps * groups * nb
    if np.ndim(w) == 4:
        t, idx, pads, scale = _per_row(x, plan, diag, rows, w)[:4]
        w = device_constant(w, x.device, x.dtype).contiguous()
        return shuffle_gemm_grouped_blocks(x.contiguous(), idx, pads, w,
                                           reps, groups, nb, scale)
    xb, blocks, w = _prepare(x, plan, diag, rows, w)
    out = ShuffleGemmFn.apply(xb, w, blocks, plan, diag, (reps, groups, nb))
    return out.reshape(*x.shape[:-1], rows * w.shape[-1])


class ShuffleGemmChain:
    """A list of grouped gather∘GEMM sub-steps (:class:`~repro_torch.
    kernels.shuffle_gemm.chain.SubStep`), sub-step s + 1 gathering from
    sub-step s's flat output, cut into segments once, here (at bind
    time).  The backward list is built on first use and cached under
    ``"hopper:vjp"`` (``vjp.backward_chain``)."""

    def __init__(self, steps):
        self.steps = tuple(steps)
        self.segments = segment_chain(self.steps)

    def report(self) -> dict:
        """The sub-steps and, per segment, its launch and tiling."""
        return {"steps": [s.name for s in self.steps],
                "segments": [g.report() for g in self.segments]}


def run_segments(xb: torch.Tensor, segments, ws) -> torch.Tensor:
    """Run ``segments`` in order on ``xb`` (B, n_in) with the sub-steps'
    ``(groups, t, n_out)`` operands ``ws`` (any of them ``(B, groups, t,
    n_out)``, one a batch row): one chain launch a segment of several
    sub-steps, the per-step kernel for a segment of one (the blocks form
    where it has one group).  -> (B, rows * n_out of the last
    sub-step)."""
    i = 0
    for seg in segments:
        w = ws[i:i + len(seg.steps)]
        i += len(seg.steps)
        if len(seg.steps) > 1:
            xb = shuffle_gemm_chain(xb, seg, w)
            continue
        (s,), ((idx, pads, scale),) = seg.steps, seg.device_tables(
            xb.device, xb.dtype)[1]
        if s.groups == 1:
            w0 = w[0][:, 0] if w[0].ndim == 4 else w[0][0]
            xb = shuffle_gemm_blocks(xb, idx, pads, w0, scale,
                                     seg.row_spans(0))
            xb = xb.reshape(xb.shape[0], -1)
        else:
            xb = shuffle_gemm_grouped_blocks(xb, idx, pads, w[0], s.reps,
                                             s.groups, s.nb, scale)
    return xb


def run_chain(x: torch.Tensor, chain: ShuffleGemmChain, ws,
              per_row=()) -> torch.Tensor:
    """x: (..., n_in); ``ws[s]``: sub-step s's operand, reshaped to
    ``(groups, t, n_out)`` -> (..., rows * n_out of the last sub-step),
    flat in its row order.  Differentiable in ``x`` and every ``w``.

    ``per_row``: the sub-steps whose ``ws[s]`` carries a leading batch
    axis, one operand a row of ``x`` (B, n_in) — the serving path's
    per-row params: the same launches, each row against its own operands,
    a forward only (as :func:`shuffle_gemm`'s per-row form)."""
    first = chain.steps[0]
    n_in = x.shape[-1]
    if int(first.plan.gather_idx.max(initial=-1)) >= n_in:
        raise ValueError(f"{first.name} reads past a length-{n_in} input")
    if per_row:
        b = x.shape[0]
        if x.ndim != 2 or any(ws[i].shape[0] != b for i in per_row):
            raise ValueError(f"per-row operands need x (B, n_in) and B "
                             f"operands; got x {tuple(x.shape)}")
        from .. import forward_only
        forward_only("per-row shuffle_gemm_chain", x,
                     *[ws[i] for i in per_row])
        ws = [device_constant(w, x.device, x.dtype).reshape(
            *((b,) if i in per_row else ()), s.groups, s.t, s.n_out)
            .contiguous() for i, (s, w) in enumerate(zip(chain.steps, ws))]
        return run_segments(x.contiguous(), chain.segments, ws)
    xb = x.reshape(-1, n_in).contiguous()
    ws = [device_constant(w, x.device, x.dtype).reshape(
        s.groups, s.t, s.n_out).contiguous()
        for s, w in zip(chain.steps, ws)]
    out = ShuffleGemmChainFn.apply(xb, chain, *ws)
    return out.reshape(*x.shape[:-1], out.shape[-1])
