"""Row tiles of the staged ``shuffle_gemm_blocks`` body, and the span of
``x`` each tile reads.

The staged body (``csrc/shuffle_gemm.cu``, body 2) takes the calls whose
``(t, n_out)`` operand every batch row shares.  A block of it owns one
tile of ``rt`` consecutive rows and a chunk of batch rows: it stages the
operand and the tile's tables in shared memory once, then brings in each
batch row's *span* of ``x`` — the positions ``[lo, hi)`` the tile's
non-PAD indices cover — by 16-byte copies, and gathers from there.  A
FIR's window, a DCT or DWT block, a mel frame: each tile reads a short
run of its row, and each input sample is fetched once a tile, not once
a tap.

:class:`RowSpans` finds the spans from the numpy index table once (per
tile size, cached), on the host, where a graph is lowered; nothing is
read back from the card per call.  :func:`staged_tiling` picks the tile
and lays out the block's shared memory from what the call shows —
``(rows, t, n_out)``, the element size, the scale, the spans — never from
the batch; the launch picks the chunks.  A call without spans (no plan),
or one the staged body does not take, runs on the sequential body, with
the same arithmetic.

Sum order (the kernels' header): t < 32 one fmaf chain over k; t >= 32
eight partial chains over k = l (mod 8), combined as a fixed tree.  A
thread owns ``nb`` batch rows x ``no`` outputs of a row; from t >= 64
the eight partials sit in eight lanes, below it one thread keeps them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional

import numpy as np

__all__ = ["RowSpans", "StagedTiling", "staged_tiling", "STAGED_THREADS",
           "SPLIT_T", "LANES_T", "SHARED_BYTES"]

STAGED_THREADS = 256          # kStagedThreads in csrc/shuffle_gemm.cu
SPLIT_T = 32                  # t from which a sum is eight partials
LANES_T = 64                  # t from which the partials sit in 8 lanes
SHARED_BYTES = 227 * 1024     # a block's opt-in shared memory on sm_90
# batch rows a thread, by (split, lanes, outputs a thread): the instances
# of staged_kernel (STAGED in csrc/shuffle_gemm.cu)
NB = {(False, 1, 1): 8, (False, 1, 4): 4, (True, 1, 1): 8, (True, 1, 4): 4,
      (True, 8, 1): 8, (True, 8, 4): 4}


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _odd_multiple(n: int, m: int) -> int:
    """The least multiple of ``m`` >= ``n`` whose quotient by ``m`` is
    odd (rows that many elements apart fall in distinct bank groups)."""
    q = -(-n // m)
    return (q + 1 - q % 2) * m


GATHER, PADDED, RUN = 0, 1, 2  # StagedMode in csrc/shuffle_gemm.cu
MIN_WORK = 16                 # multiply-adds a row's output (t x n_out)
#                               from which staging pays: below it a
#                               thread's whole output is a few FMAs on
#                               values the sequential body loads directly
MIN_TILES = 64                # tiles a call takes where its rows allow
REREAD = 1.25                 # x staged a batch row, at most this over
#                               the largest tile's


class RowSpans:
    """The spans of a ``(rows, t)`` index table's row tiles: per tile of
    ``rt`` rows, ``[lo, hi)`` of the positions its non-PAD indices read
    (``(0, 0)`` for a tile of PAD entries only), and how the staged body
    reads the table: ``mode`` :data:`RUN` where every row reads one
    contiguous run (``idx[r, k] = idx[r, 0] + k``, no PAD), :data:`PADDED`
    where it has PAD entries, else :data:`GATHER`; ``zero_pads`` where
    every PAD value (times its scale) is 0, a value the kernel needs no
    table for.  Built from numpy arrays; each tile size's spans are
    computed once and kept, on the host and per device."""

    def __init__(self, idx, pads=None, scale=None):
        idx = np.asarray(idx).astype(np.int64)
        if idx.ndim != 2:
            raise ValueError(f"idx must be (rows, t); got {idx.shape}")
        self.rows, self.t = idx.shape
        big = np.iinfo(np.int64).max
        self._lo = np.where(idx < 0, big, idx).min(axis=1, initial=big)
        self._hi = np.where(idx < 0, -1, idx).max(axis=1, initial=-1) + 1
        at_pad = idx < 0
        self.zero_pads = True
        if at_pad.any():
            self.mode = PADDED
            v = np.zeros(int(at_pad.sum())) if pads is None else \
                np.asarray(pads, np.float64).reshape(idx.shape)[at_pad]
            if scale is not None:
                v = v * np.asarray(scale, np.float64).reshape(
                    idx.shape)[at_pad]
            self.zero_pads = bool((v == 0).all())
        elif idx.size and bool((idx == idx[:, :1] + np.arange(
                self.t)).all()):
            self.mode = RUN
        else:
            self.mode = GATHER
        self._tiles: Dict[int, np.ndarray] = {}
        self._device: Dict = {}
        self._tilings: Dict = {}

    def tiles(self, rt: int) -> np.ndarray:
        """``(ceil(rows / rt), 2)`` int32: each tile's ``(lo, hi)``."""
        hit = self._tiles.get(rt)
        if hit is None:
            n = -(-self.rows // rt)
            pad = n * rt - self.rows
            lo = np.pad(self._lo, (0, pad), constant_values=np.iinfo(
                np.int64).max).reshape(n, rt).min(axis=1)
            hi = np.pad(self._hi, (0, pad)).reshape(n, rt).max(axis=1)
            empty = hi <= 0
            hit = np.stack([np.where(empty, 0, lo), np.where(empty, 0, hi)],
                           axis=1).astype(np.int32)
            self._tiles[rt] = hit
        return hit

    def max_span(self, rt: int) -> int:
        """The widest tile's ``hi - lo``."""
        t = self.tiles(rt)
        return int((t[:, 1] - t[:, 0]).max(initial=0))

    def staged(self, rt: int) -> int:
        """Elements of x a batch row's tiles stage together."""
        key = ("staged", rt)
        hit = self._device.get(key)
        if hit is None:
            t = self.tiles(rt)
            hit = self._device[key] = int((t[:, 1] - t[:, 0]).sum())
        return hit

    def affine(self, rt: int) -> Optional[tuple]:
        """``(step, hi0, length)`` where every tile's span lies in
        ``[max(0, hi - length), hi)``, ``hi = hi0 + q * step``, with
        ``length`` the widest span (the kernel then needs no table of
        them: a FIR's windows, in-order rows); else None."""
        t = self.tiles(rt).astype(np.int64)
        length = self.max_span(rt)
        hi0 = int(t[0, 1])
        step = int(t[1, 1] - t[0, 1]) if len(t) > 1 else 0
        hi = hi0 + step * np.arange(len(t))
        lo = np.maximum(0, hi - length)
        used = t[:, 1] > t[:, 0]
        if length and bool(((lo <= t[:, 0]) & (hi >= t[:, 1]))[used].all()):
            return step, hi0, length
        return None

    def on(self, rt: int, device):
        """:meth:`tiles` as an int32 tensor on ``device`` (kept)."""
        import torch
        key = (rt, str(torch.device(device)))
        hit = self._device.get(key)
        if hit is None:
            hit = self._device[key] = torch.as_tensor(
                self.tiles(rt), device=device).contiguous()
        return hit


@dataclasses.dataclass(frozen=True)
class StagedTiling:
    """The staged body's block: ``rt`` rows a tile; ``lanes`` (1 or 8)
    splitting each output's K; ``no`` outputs and ``nb`` batch rows a
    thread; ``split`` (t >= 32); ``bg`` batch groups a pass; ``threads``
    a block.  Shared memory, in bytes from 0: the operand (``t`` rows of
    ``ws`` elements; where ``wxor``, row k's 16-byte chunk j at
    ``j ^ (k & wxor)``), the tile's tables as they lie in device memory
    but ``rs`` elements a row — the indices (int32) at ``off_idx``, the
    PAD values at ``off_pad`` and the scales at ``off_scale`` (in the
    input type; -1: none) —, two buffers of ``bg * nb`` batch rows of
    ``row_bytes`` at ``off_buf``; ``total`` in all.  ``mode``: how rows
    read (:data:`GATHER`, :data:`PADDED`, :data:`RUN`); ``affine``: the
    spans' ``(step, hi0, length)`` where they have that form, else None
    (the launch passes their table); ``span`` the widest tile's span of
    ``x``."""
    rt: int
    lanes: int
    no: int
    nb: int
    split: bool
    bg: int
    threads: int
    ws: int
    wxor: int
    rs: int
    row_bytes: int
    off_idx: int
    off_pad: int
    off_scale: int
    off_buf: int
    total: int
    mode: int
    affine: Optional[tuple]
    span: int

    def dims(self) -> tuple:
        """The C entry's 20 layout ints (``kStagedDims``): the spans'
        ``(step, hi0, length)`` where affine, else ``(0, 0, span)`` (the
        table's), then ``wxor``."""
        return (self.rt, self.lanes, self.no, self.nb, int(self.split),
                self.bg, self.threads, self.ws, self.rs, self.row_bytes,
                self.off_idx, self.off_pad, self.off_scale, self.off_buf,
                self.total, self.mode, *(self.affine or (0, 0, self.span)),
                self.wxor)

    @functools.cached_property
    def launch_dims(self):
        """:meth:`dims` as the C entry's ``int`` array, with room for the
        four ints a launch writes after them; built once, each launch
        takes a copy (``type(a).from_buffer_copy(a)``)."""
        dims = self.dims()
        return (ctypes.c_int * (len(dims) + 4))(*dims)


def _layout(rows, t, n_out, elem_bytes, scaled, split, lanes, no, nb, rt,
            spans: RowSpans) -> Optional[StagedTiling]:
    """The layout of tiles of ``rt`` rows (its natural batch groups only
    shrink where the buffers would not fit), or None."""
    span, mode = spans.max_span(rt), spans.mode
    per_row = n_out // no * lanes
    cols = rt * per_row
    bg = max(1, STAGED_THREADS // cols)
    # the tables' rows an odd count of 4-byte units apart (threads of
    # consecutive rows read distinct banks); w as it lies, but where 8
    # lanes read 8 rows of a power of two of 8 or more 16-byte chunks
    # each, row k's chunk j at j ^ (k & 7) (the 8 lanes read distinct
    # banks; the copy stays 16-byte runs)
    chunks = n_out * elem_bytes // 16
    wxor = 7 if (lanes == 8 and no == 4 and n_out * elem_bytes % 16 == 0
                 and chunks >= 8 and chunks & (chunks - 1) == 0) else 0
    rs = _odd_multiple(t, 1) if lanes == 1 else _odd_multiple(t, 8)
    entries = (rt - 1) * rs + t
    # the chunks a span's 16-byte copies touch (one more where it starts
    # off a 16-byte boundary), rows four banks apart
    row_bytes = (-(-span * elem_bytes // 16) + 1) * 16
    while row_bytes // 4 % 32 != 4:
        row_bytes += 16
    pad_table = mode == PADDED and not spans.zero_pads
    off = _align16(t * n_out * elem_bytes)
    off_idx = off
    off += _align16(4 * entries)
    off_pad = off if pad_table else -1
    off += _align16(elem_bytes * entries) if pad_table else 0
    off_scale = off if scaled else -1
    off += _align16(elem_bytes * entries) if scaled else 0
    while bg > 1 and off + 2 * bg * nb * row_bytes > SHARED_BYTES:
        bg //= 2                      # fewer batch rows a pass
    total = off + 2 * bg * nb * row_bytes
    if total > SHARED_BYTES:
        return None
    threads = min(STAGED_THREADS, -(-bg * cols // 32) * 32)
    return StagedTiling(rt, lanes, no, nb, split, bg, threads, n_out, wxor,
                        rs, row_bytes, off_idx, off_pad, off_scale, off,
                        total, mode, spans.affine(rt), span)


def staged_tiling(rows: int, t: int, n_out: int, elem_bytes: int,
                  scaled: bool, spans: Optional[RowSpans]
                  ) -> Optional[StagedTiling]:
    """The staged body's tiling of a shared-operand call, or None where
    it does not take the call: no spans, a row of fewer than
    :data:`MIN_WORK` multiply-adds an output (``t * n_out``), or no
    layout within :data:`SHARED_BYTES`.  A thread owns 4 outputs where
    ``n_out`` is a multiple of 4, else one, and :data:`NB` batch rows.

    The tile: at most one thread a column of :data:`STAGED_THREADS`
    (``rt_max`` rows); of the power-of-two sizes below it whose layout
    fits and whose tiles together stage at most :data:`REREAD` times the
    x that ``rt_max``'s do, the largest that makes :data:`MIN_TILES`
    tiles (or all ``rows``), else the smallest (the most blocks for a
    small batch, no wasted staging for a large one)."""
    if spans is None or rows < 1 or t < 1 or n_out * t < MIN_WORK:
        return None
    if (spans.rows, spans.t) != (rows, t):
        raise ValueError(f"spans of a ({spans.rows}, {spans.t}) table for "
                         f"a ({rows}, {t}) call")
    key = (n_out, elem_bytes, scaled)          # once a plan and operand form
    if key not in spans._tilings:
        spans._tilings[key] = _choose(rows, t, n_out, elem_bytes, scaled,
                                      spans)
    return spans._tilings[key]


def _choose(rows, t, n_out, elem_bytes, scaled, spans):
    """:func:`staged_tiling`'s choice, made once a plan and operand form."""
    split = t >= SPLIT_T
    lanes = 8 if t >= LANES_T else 1
    no = 4 if n_out % 4 == 0 else 1
    nb = NB[(split, lanes, no)]
    per_row = n_out // no * lanes               # threads a row takes
    rt_max = max(1, min(rows, STAGED_THREADS // per_row))
    sizes = [rt_max] + [1 << j for j in range(rt_max.bit_length())
                        if (1 << j) < rt_max][::-1]
    fit = [(rt, _layout(rows, t, n_out, elem_bytes, scaled, split, lanes,
                        no, nb, rt, spans))
           for rt in sizes
           if spans.staged(rt) <= REREAD * spans.staged(rt_max)]
    fit = [(rt, tl) for rt, tl in fit if tl is not None]
    if not fit:
        return None
    many = [tl for rt, tl in fit if -(-rows // rt) >= min(MIN_TILES, rows)]
    return many[0] if many else fit[-1][1]
