"""Wrappers of the fused shuffling-fabric + GEMM CUDA kernels.

The kernels (``kernels/csrc/shuffle_gemm.cu``) take the place of the JAX
package's Pallas TPU kernels of the same names:

    out[b, r, :] = (x[b, idx[r, :]] | pad) (* scale) @ w

  * :func:`shuffle_gemm_blocks` — one shared ``(t, n_out)`` operand for
    every row (FIR taps, DCT matrix, mel filterbank), or one ``(t,
    n_out)`` operand a batch row, ``w (B, t, n_out)``: each request of a
    served wave with its own registered weights, in one launch.
  * :func:`shuffle_gemm_grouped_blocks` — a *grouped* operand
    ``(G, t, n_out)``: row ``r`` (flat layout ``(reps, G, nb)``)
    contracts against group ``(r // nb) % G`` — the FFT butterfly shape;
    or one such operand a batch row, ``w (B, G, t, n_out)``.
  * :func:`shuffle_gemm_chain` — a segment of grouped sub-steps
    (:class:`~repro_torch.kernels.shuffle_gemm.chain.ChainSegment`),
    each gathering from the one before, in one launch; bit for bit the
    sub-steps launched one at a time (:func:`shuffle_gemm_steps`).  Any
    sub-step's operand may carry a batch axis, one a batch row.

Each wrapper runs the plain PyTorch version (``ref.py``) for a tensor on
the CPU, and for a tensor on the card checks device, type, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch reports an error.  It counts its
launches in its ``launches`` attribute, a plain integer incremented once
per kernel launch and nowhere else.  :func:`blocks_launch_args` and
:func:`chain_launch_args` give a launch's C arguments; the ``dims``
array among them holds, after the launch, what it ran (body, grid,
tiles a block).

Indices must lie in ``[-1, n_in)`` (-1 = PAD); the kernel does not
bounds-check them.  ``ops.py`` validates every plan once before its
first launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .ref import (ref_shuffle_gemm_blocks, ref_shuffle_gemm_chain,
                  ref_shuffle_gemm_grouped_blocks)
from .tiling import RowSpans, staged_tiling

__all__ = ["shuffle_gemm_blocks", "shuffle_gemm_grouped_blocks",
           "shuffle_gemm_chain", "shuffle_gemm_steps", "chain_steps",
           "ref_chain", "launch_counts", "reset_launch_counts",
           "blocks_launch_args", "chain_launch_args", "blocks_tiling",
           "BODIES"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 2 ** 31 - 1          # the C entries take the batch as an int
_CHAIN_INTS = 3                   # ints a chain launch writes after its dims
_STAGED_DIMS = 20                 # kStagedDims in csrc/shuffle_gemm.cu
_BLOCKS_INTS = 4                  # ints a blocks launch writes after them
_BLOCKS_DIMS = ctypes.c_int * (_STAGED_DIMS + _BLOCKS_INTS)


def _check(x, idx, pad_vals, w, scale, w_rank):
    from .. import check_operands
    if x.device.type == "cuda" and x.dtype not in _DTYPE_CODES:
        raise TypeError(f"shuffle_gemm kernels take float32 or bfloat16; "
                        f"got {x.dtype}")
    operands = {"x": (x, x.dtype), "idx": (idx, torch.int32),
                "pad_vals": (pad_vals, x.dtype), "w": (w, x.dtype)}
    if scale is not None:
        operands["scale"] = (scale, x.dtype)
    check_operands("shuffle_gemm", operands)
    if x.ndim != 2 or idx.ndim != 2 or w.ndim not in w_rank:
        raise ValueError(f"shapes: x {tuple(x.shape)} must be (B, n_in), "
                         f"idx {tuple(idx.shape)} (R, t), w "
                         f"{tuple(w.shape)} rank "
                         f"{' or '.join(map(str, w_rank))}")
    if pad_vals.shape != idx.shape or (scale is not None
                                       and scale.shape != idx.shape):
        raise ValueError("pad_vals / scale must match idx's (R, t) shape")
    if w.shape[-2] != idx.shape[1]:
        raise ValueError(f"w contracts over {w.shape[-2]}, rows hold "
                         f"{idx.shape[1]} elements")
    if x.shape[0] > _MAX_BATCH:
        raise ValueError(f"batch {x.shape[0]} exceeds {_MAX_BATCH}")


def _launch(entry, x, idx, pad_vals, w, scale, out, *ints):
    from .. import launch
    launch(entry, x.device, x.data_ptr(), idx.data_ptr(),
           pad_vals.data_ptr(), None if scale is None else scale.data_ptr(),
           w.data_ptr(), out.data_ptr(), *ints, _DTYPE_CODES[x.dtype])


def blocks_tiling(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  spans: Optional[RowSpans] = None):
    """The staged body's tiling of a ``shuffle_gemm_blocks`` call on
    these arguments, or None where it runs on another body (the launch
    picks the wide one for a per-row operand at t >= 32 where it fits,
    else the sequential one).  It reads the call's shapes, type, scale
    and spans, never its batch."""
    if w.ndim != 2:
        return None
    (r, t), n_out = idx.shape, w.shape[-1]
    return staged_tiling(r, t, n_out, x.element_size(), scale is not None,
                         spans)


# the bodies a blocks launch reports in its dims' last int
BODIES = ("sequential", "wide", "staged")


def blocks_launch_args(x: torch.Tensor, idx: torch.Tensor,
                       pad_vals: torch.Tensor, w: torch.Tensor,
                       scale: Optional[torch.Tensor] = None,
                       spans: Optional[RowSpans] = None) -> tuple:
    """Check a :func:`shuffle_gemm_blocks` call on the card and allocate
    its output: ``(out, args)`` with ``args`` the arguments of the C entry
    ``repro_shuffle_gemm_blocks`` before the stream.  Its ``dims`` array
    (``args[13]``) holds the staged layout (:func:`blocks_tiling`) and,
    after the launch, what the launch ran: its grid's x and y, the rows
    (wide body) or batch rows (staged body) a block, and the body (an
    index into :data:`BODIES`)."""
    _check(x, idx, pad_vals, w, scale, w_rank=(2, 3))
    (b, n_in), (r, t), n_out = x.shape, idx.shape, w.shape[-1]
    if w.ndim == 3 and w.shape[0] != b:
        raise ValueError(f"w {tuple(w.shape)} holds {w.shape[0]} operands "
                         f"for a batch of {b}")
    out = torch.empty((b, r, n_out), dtype=x.dtype, device=x.device)
    tiling = blocks_tiling(x, idx, w, scale, spans)
    if tiling is None:
        dims = _BLOCKS_DIMS()
    else:
        dims = _BLOCKS_DIMS.from_buffer_copy(tiling.launch_dims)
    span_t = (spans.on(tiling.rt, x.device)
              if tiling is not None and tiling.affine is None else None)
    return out, (x.data_ptr(), idx.data_ptr(), pad_vals.data_ptr(),
                 None if scale is None else scale.data_ptr(), w.data_ptr(),
                 out.data_ptr(), b, n_in, r, t, n_out,
                 t * n_out if w.ndim == 3 else 0,
                 None if span_t is None else span_t.data_ptr(), dims,
                 _DTYPE_CODES[x.dtype])


def shuffle_gemm_blocks(x: torch.Tensor, idx: torch.Tensor,
                        pad_vals: torch.Tensor, w: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        spans: Optional[RowSpans] = None) -> torch.Tensor:
    """x: (B, n_in); idx/pad_vals[/scale]: (R, t); w: (t, n_out), shared
    by every batch row, or (B, t, n_out), batch row b against w[b] ->
    (B, R, n_out).  Replaces ``repro.kernels.shuffle_gemm.kernel.
    shuffle_gemm_blocks`` (its per-row form: the JAX package's ``vmap``
    over that kernel); rows need no padding to a block multiple.
    ``spans``, the :class:`~repro_torch.kernels.shuffle_gemm.tiling.
    RowSpans` of the numpy table ``idx`` was made from, lets a shared
    operand's call stage each row tile's span of ``x``
    (:func:`blocks_tiling`).  Every output's sum runs in an order set by
    ``t`` alone, so row b of a per-row call is bit for bit the shared
    call on w[b], and a row's result does not depend on the batch it sits
    in."""
    if x.device.type == "cpu":
        return ref_shuffle_gemm_blocks(x, idx, pad_vals, w, scale)
    out, args = blocks_launch_args(x, idx, pad_vals, w, scale, spans)
    if out.numel():
        from .. import launch
        launch("repro_shuffle_gemm_blocks", x.device, *args)
        shuffle_gemm_blocks.launches += 1
    return out


def shuffle_gemm_grouped_blocks(x: torch.Tensor, idx: torch.Tensor,
                                pad_vals: torch.Tensor, w: torch.Tensor,
                                reps: int, groups: int, nb: int,
                                scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """x: (B, n_in); idx/pad_vals[/scale]: (R, t) with R = reps*G*nb in
    (reps, G, nb) row order; w: (G, t, n_out), shared by every batch row,
    or (B, G, t, n_out), batch row b against w[b] -> (B, R * n_out) flat
    in the same row order.  Replaces ``repro.kernels.shuffle_gemm.kernel.
    shuffle_gemm_grouped_blocks`` (its per-row form: the JAX package's
    ``vmap`` over that kernel).  Each output's sum runs in an order set by
    ``t`` alone, so row b of a per-row call is bit for bit the shared call
    on w[b]."""
    if x.device.type == "cpu":
        return ref_shuffle_gemm_grouped_blocks(x, idx, pad_vals, w, reps,
                                               groups, nb, scale)
    _check(x, idx, pad_vals, w, scale, w_rank=(3, 4))
    (b, n_in), (r, t), n_out = x.shape, idx.shape, w.shape[-1]
    if r != reps * groups * nb or w.shape[-3] != groups:
        raise ValueError(f"R={r} must equal reps*groups*nb="
                         f"{reps * groups * nb} and w must hold {groups} "
                         f"groups (has {w.shape[-3]})")
    if w.ndim == 4 and w.shape[0] != b:
        raise ValueError(f"w {tuple(w.shape)} holds {w.shape[0]} operands "
                         f"for a batch of {b}")
    out = torch.empty((b, r * n_out), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch("repro_shuffle_gemm_grouped_blocks",
                x, idx, pad_vals, w, scale, out, b, n_in, reps, groups, nb,
                t, n_out, groups * t * n_out if w.ndim == 4 else 0)
        shuffle_gemm_grouped_blocks.launches += 1
    return out


def chain_steps(segment, ws: Sequence[torch.Tensor], device, dtype):
    """The segment's sub-steps as the per-step kernels' arguments:
    ``[(idx, pad_vals, w, reps, groups, nb, scale)]`` with the plain
    ``(rows, t)`` tables on ``device`` in ``dtype`` and ``ws[s]`` the
    ``(groups, t, n_out)`` operand of sub-step s, or ``(B, groups, t,
    n_out)``, one a batch row."""
    _, plain = segment.device_tables(device, dtype)
    return [(idx, pads, w, s.reps, s.groups, s.nb, scale)
            for s, (idx, pads, scale), w in zip(segment.steps, plain, ws)]


def ref_chain(x: torch.Tensor, segment,
              ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain version of :func:`shuffle_gemm_chain`, on its
    arguments."""
    return ref_shuffle_gemm_chain(x, chain_steps(segment, ws, x.device,
                                                 x.dtype))


def shuffle_gemm_steps(x: torch.Tensor, segment,
                       ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """The segment's sub-steps launched one at a time through
    :func:`shuffle_gemm_grouped_blocks` (whose body the chain kernel's
    arithmetic repeats at every ``t``)."""
    for idx, pads, w, reps, groups, nb, scale in chain_steps(
            segment, ws, x.device, x.dtype):
        x = shuffle_gemm_grouped_blocks(x, idx, pads, w, reps, groups, nb,
                                        scale)
    return x


def chain_launch_args(x: torch.Tensor, segment,
                      ws: Sequence[torch.Tensor]) -> tuple:
    """Check a chain call on the card and allocate its output: ``(out,
    args)`` with ``args`` the arguments of the C entry
    ``repro_shuffle_gemm_chain`` before the stream.  Its ``dims`` array
    (``args[6]``) holds, after the launch, the blocks it ran, the tiles a
    block holds at once (its slots, picked by the launch from the batch
    and the card's SMs, at most the segment's ``tiles_per_cta``) and the
    shared bytes a block; ``args[7]`` has bit s set where ``ws[s]`` is
    ``(B, groups, t, n_out)``, one operand a batch row."""
    from .. import check_operands
    from .chain import MAX_SUBSTEPS
    steps = segment.steps
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"shuffle_gemm kernels take float32 or bfloat16; "
                        f"got {x.dtype}")
    check_operands("shuffle_gemm_chain",
                   {"x": (x, x.dtype), **{f"w{i}": (w, x.dtype)
                                          for i, w in enumerate(ws)}})
    if x.ndim != 2 or len(ws) != len(steps) \
            or not 1 <= len(steps) <= MAX_SUBSTEPS:
        raise ValueError(f"x {tuple(x.shape)} must be (B, n_in) and ws one "
                         f"operand per sub-step ({len(ws)} for "
                         f"{len(steps)}, at most {MAX_SUBSTEPS})")
    (b, n_in), first = x.shape, steps[0]
    rows_mask = 0
    for i, (s, w) in enumerate(zip(steps, ws)):
        shape = (s.groups, s.t, s.n_out)
        if tuple(w.shape) not in (shape, (b, *shape)):
            raise ValueError(f"{s.name}: w {tuple(w.shape)} must be "
                             f"{shape} or {(b, *shape)}")
        rows_mask |= (w.ndim == 4) << i
    if int(first.plan.gather_idx.max(initial=-1)) >= n_in:
        raise ValueError(f"{first.name} reads past a length-{n_in} input")
    kern, _ = segment.device_tables(x.device, x.dtype)
    last = steps[-1]
    out = torch.empty((b, last.rows * last.n_out), dtype=x.dtype,
                      device=x.device)
    ptrs = (ctypes.c_void_p * (len(steps) + 5))(*[
        None if a is None or not a.numel() else a.data_ptr()
        for a in (*kern["first"], *ws, kern["shared"], kern["own"])])
    static = _chain_dims(segment, kern["layout"])
    dims = (ctypes.c_int * (len(static) + _CHAIN_INTS))(*static)
    return out, (x.data_ptr(), out.data_ptr(), b, n_in, len(steps), ptrs,
                 dims, ctypes.c_int(rows_mask).value, _DTYPE_CODES[x.dtype])


def _chain_dims(segment, lay) -> tuple:
    """The C entry's dims of ``segment`` in layout ``lay``, built once a
    segment and layout."""
    key = ("dims", id(lay))
    hit = segment._device.get(key)
    if hit is None or hit[0] is not lay:
        static = (
            segment.tiles, segment.tiles_per_cta, segment.slot_rows,
            *lay.shared, lay.own_bytes, lay.buf_floats, lay.fixed,
            int(segment.zero_pads0),
            *[v for s, per, offs, perm, pair, swz in zip(
                segment.steps, segment.periodic, lay.steps, lay.perms,
                segment.pairs, segment.swz)
              for v in (s.rows, s.t, s.n_out, s.groups, s.nb, int(per),
                        *offs, int(perm), int(pair), int(swz))])
        hit = segment._device[key] = (lay, static)
    return hit[1]


def shuffle_gemm_chain(x: torch.Tensor, segment,
                       ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """x: (B, n_in); ``segment`` a
    :class:`~repro_torch.kernels.shuffle_gemm.chain.ChainSegment` of S
    sub-steps; ``ws[s]``: sub-step s's ``(groups, t, n_out)`` operand ->
    (B, rows * n_out of the last sub-step), flat, in one launch: every
    sub-step after the first runs tile by tile in shared memory, each
    block staging the shared tables and the operands once for all the
    tiles it walks.  A ``ws[s]`` of ``(B, groups, t, n_out)``, one a batch
    row, is read by each row from device memory instead (the kernel's
    per-row instance).  Bit for bit :func:`shuffle_gemm_steps` on the same
    arguments."""
    if x.device.type == "cpu":
        return ref_chain(x, segment, ws)
    out, args = chain_launch_args(x, segment, ws)
    if out.numel():
        from .. import launch
        launch("repro_shuffle_gemm_chain", x.device, *args)
        shuffle_gemm_chain.launches += 1
    return out


shuffle_gemm_blocks.launches = 0
shuffle_gemm_grouped_blocks.launches = 0
shuffle_gemm_chain.launches = 0
_WRAPPERS = (shuffle_gemm_blocks, shuffle_gemm_grouped_blocks,
             shuffle_gemm_chain)


def launch_counts() -> dict:
    """``{kernel name: launches}`` of every wrapper in this module."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
