"""Chains of gather∘GEMM sub-steps, cut into segments of one launch each.

A *chain* is a list of S >= 1 sub-steps in which sub-step s + 1 gathers
from sub-step s's flat output: the consecutive butterflies of an
STFT/iSTFT stage, or the transposed GEMMs and adjoint reductions of
their backward pass.  Each sub-step is the grouped kernel's function

    out[b, r, :] = (where(idx[r] < 0, pad[r], in[b, idx[r]]) * scale[r])
                   @ w[(r // nb) % G]

with its own tables (``rows`` x ``t``), ``n_out``, ``G`` and ``nb``.
The CUDA chain kernel (``csrc/shuffle_gemm.cu``) runs a whole segment
of such sub-steps in one launch, between two shared-memory buffers;
this module decides, from the index tables alone, on the host and once
per chain, where that is possible.

**Tiles.**  A tiling of a segment cuts every sub-step's rows into
``tiles`` equal contiguous chunks (and so its flat output into equal
chunks of ``rows / tiles * n_out`` values).  It is *valid* when every
sub-step after the first reads, in each row of chunk k, only positions
of chunk k of the sub-step before it (PAD entries read nothing).  A
block of the kernel then runs a tile of a batch row from start to end
with no value from another block; the first sub-step may read anywhere
in the segment's input, which lies in device memory.  The tiling kept
is the valid one with the most tiles: the smallest buffers and the most
blocks.  For the Fig-9 STFT (frame 256, 31 frames a batch row) that is
31 tiles of 512 floats, one a frame; an FFT's butterflies read across
the whole transform, one tile a batch row.

**Slots.**  The kernel's blocks are persistent: each stages the shared
tables and every operand once, then walks the launch's (batch row,
tile) pairs ``tiles_per_cta`` at a time — its *slots*, each with its
own buffers and own tables.  :func:`_tiles_per_cta` gives a block as
many slots as hold :data:`MAX_BLOCK_ROWS` rows of the widest sub-step
within shared memory; the launch uses fewer where the batch is small
(enough blocks for the SMs), which changes no value: every tile is
computed alone.

**Segments.**  :func:`segment_chain` cuts a list greedily: a segment
grows by one sub-step while its best tiling's per-block shared memory
(two buffers plus the staged tables of every sub-step after the first,
:func:`shared_bytes`, the kernel's own layout) fits in
:data:`SHARED_BYTES`, and while it holds at most :data:`MAX_SUBSTEPS`.
A sub-step that reads across the tiles of every tiling that fits starts
a new segment.  A segment of one sub-step launches the per-step kernel.

**Tables.**  The kernel reads sub-step s >= 2's indices relative to
the tile, so each such table is rebased by its chunk's first position.
Where every tile's rebased tables (indices, PAD values, scale) are the
same (``periodic``; every frame of an STFT does the same butterflies)
one tile's copy serves all of them.

**Layout.**  :func:`chain_layout` places everything a block holds in
shared memory: a fixed region staged once (descriptors, the periodic
tables, the operands), then per slot its own tables, its share of two
buffers and its (batch row, tile) entry; the kernel takes the offsets as
given and places the slots' regions after the fixed one for the slots
it uses.  The tables of every sub-step after the first are packed on
the host, in that layout, into two device buffers: the periodic
sub-steps' (one copy, read by every block) and the others' (one row a
tile).  A block stages each by contiguous 16-byte copies, and each
operand by one more run.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...core.fabric import PAD, ShufflePlan

__all__ = ["SubStep", "ChainSegment", "ChainLayout", "segment_chain",
           "best_tiles", "chain_layout", "shared_bytes", "swizzle",
           "w_perm", "SHARED_BYTES", "MAX_SUBSTEPS", "MAX_BLOCK_ROWS",
           "MAX_SLOTS"]

SHARED_BYTES = 227 * 1024     # a block's opt-in shared memory on sm_90
MAX_SUBSTEPS = 32             # kMaxSub in csrc/shuffle_gemm.cu
MAX_BLOCK_ROWS = 2048         # rows a block's slots hold at most (4 a
#                               thread at its 512 threads)
MAX_SLOTS = 64                # slots a block (at most its threads)
STEP_BYTES = 88               # sizeof(Step) in csrc/shuffle_gemm.cu


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def swizzle(p):
    """Where the kernel keeps buffered position ``p`` of a tile whose
    output it swizzles: the 16-byte chunk ``p >> 2`` xor'ed in its low
    three bits with bits 5-7 of ``p`` (inside each aligned 32-float
    block; a float4 stays whole, a pair (2i, 2i + 1) stays a pair).  PAD
    (negative) entries stay as they are."""
    p = np.asarray(p)
    return np.where(p >= 0, p ^ (((p >> 5) & 7) << 2), p)


def w_perm(step: "SubStep", elem_bytes: int = 4, first: bool = False
           ) -> bool:
    """Whether the kernel stages a later butterfly's operand (float32, t
    4, n_out 4, several groups, fewer than 8 rows a group) with group g's
    16-byte chunk kk at ``kk ^ ((g >> 1) & 3)``: the 8 rows of a
    quarter-warp then read their groups' chunks from distinct banks,
    where the plain layout puts them on two.  Rows of 8 or more a group
    read one group's chunks together (a broadcast) and keep the plain
    layout's constant offsets."""
    return (not first and elem_bytes == 4 and step.t == 4
            and step.n_out == 4 and step.groups > 1 and step.nb < 8)


@dataclasses.dataclass(eq=False)
class SubStep:
    """One gather∘GEMM sub-step: the gather ``plan`` (+ optional
    per-element ``diag`` scale) read as ``(rows, t)`` tables, contracted
    against a ``(groups, t, n_out)`` operand, row ``r`` against group
    ``(r // nb) % groups``.  The blocks form is ``groups = 1``, ``nb =
    rows``.  ``name`` labels it in reports."""
    name: str
    plan: ShufflePlan
    diag: Optional[np.ndarray]
    rows: int
    n_out: int
    groups: int = 1
    nb: int = 0

    def __post_init__(self):
        if self.rows <= 0 or self.plan.n_out % self.rows:
            raise ValueError(f"{self.name}: plan of {self.plan.n_out} "
                             f"elements does not split into {self.rows} "
                             f"rows")
        self.nb = self.nb or self.rows // self.groups
        if self.rows % (self.groups * self.nb):
            raise ValueError(f"{self.name}: rows {self.rows} is no multiple "
                             f"of groups x nb = {self.groups * self.nb}")

    @property
    def t(self) -> int:
        return self.plan.n_out // self.rows

    @property
    def reps(self) -> int:
        return self.rows // (self.groups * self.nb)

    @property
    def n_elems(self) -> int:
        """Length of the flat output of one batch row."""
        return self.rows * self.n_out

    @property
    def idx(self) -> np.ndarray:
        return self.plan.gather_idx.reshape(self.rows, self.t)

    @property
    def has_pad(self) -> bool:
        return bool((self.plan.gather_idx == PAD).any())


def _tile_valid(steps: Sequence[SubStep], tiles: int) -> bool:
    for prev, s in zip(steps, steps[1:]):
        rpt, ept = s.rows // tiles, prev.n_elems // tiles
        idx = s.idx
        tile_of_row = (np.arange(s.rows) // rpt)[:, None]
        read = idx >= 0
        if not np.array_equal((idx // ept)[read],
                              np.broadcast_to(tile_of_row, idx.shape)[read]):
            return False
    return True


def best_tiles(steps: Sequence[SubStep]) -> int:
    """The largest tile count of a valid tiling of ``steps`` (1, the
    whole flat vector of a batch row, is always valid)."""
    g = 0
    for s in steps:
        g = math.gcd(g, s.rows)
    for c in sorted((d for d in range(1, g + 1) if g % d == 0),
                    reverse=True):
        if c == 1 or _tile_valid(steps, c):
            return c
    return 1


def _rebased(steps: Sequence[SubStep], tiles: int):
    """Per sub-step: the tables in the kernel's form (``idx`` rebased to
    the tile for every sub-step after the first) and whether every
    tile's tables are the same (``periodic``)."""
    out = []
    for i, s in enumerate(steps):
        idx = s.idx
        pads = np.asarray(s.plan.pad_values).reshape(s.rows, s.t)
        scale = None if s.diag is None else \
            np.asarray(s.diag).reshape(s.rows, s.t)
        if i == 0:
            out.append((idx, pads, scale, False))
            continue
        rpt, ept = s.rows // tiles, steps[i - 1].n_elems // tiles
        base = (np.arange(s.rows) // rpt * ept)[:, None]
        local = np.where(idx >= 0, idx - base, PAD).astype(np.int32)
        periodic = all(a is None or bool(
            (a.reshape(tiles, -1) == a.reshape(tiles, -1)[:1]).all())
            for a in (local, pads, scale))
        out.append((local, pads, scale, periodic))
    return out


@dataclasses.dataclass(frozen=True)
class ChainLayout:
    """Where the chain kernel's block keeps what it holds in shared
    memory, in bytes.  The fixed region, staged once a block: the
    sub-steps' descriptors at 0, the periodic sub-steps' tables
    (``shared``: offset, bytes), the operands; ``fixed`` bytes in all.
    Then, per slot, from ``fixed`` on: its own tables (``own_bytes``, the
    other sub-steps' tables for one tile) and its share of two float32
    buffers (``buf_floats`` a slot: a tile of the largest buffered
    output); for ``slots`` slots ``total`` bytes.  Per sub-step ``(idx,
    pad, scale, w)`` offsets (-1 where it has none; sub-step 0 reads its
    own from device memory): from 0 for a periodic sub-step's tables and
    every operand, from the slot's own tables for the others' tables;
    ``perms``, per operand :func:`w_perm`.  Every offset is a multiple
    of 16."""
    shared: Tuple[int, int]
    steps: Tuple[Tuple[int, int, int, int], ...]
    fixed: int
    own_bytes: int
    buf_floats: int
    slots: int
    total: int
    perms: Tuple[bool, ...] = ()


def _slot_bytes(fixed: int, own_bytes: int, buf_floats: int,
                slots: int) -> int:
    """Bytes of a block with ``slots`` slots (the kernel's own sum)."""
    return fixed + slots * own_bytes + 2 * _align16(4 * slots * buf_floats)


def chain_layout(steps: Sequence[SubStep], tiles: int, slots: int,
                 periodic: Sequence[bool], elem_bytes: int = 4
                 ) -> ChainLayout:
    """The shared-memory layout of one block (see :class:`ChainLayout`):
    descriptors (:data:`STEP_BYTES` each); the periodic sub-steps'
    tables, then each operand; then the slots' regions.  A sub-step's
    tables: its index table, its PAD values when it has a PAD entry and
    its scale when it has one (``elem_bytes`` a value), for one tile's
    rows.  Each region is rounded up to 16 bytes."""
    off = _align16(STEP_BYTES * len(steps))
    offs = [[-1, -1, -1, -1] for _ in steps]

    def tables(i, s, at):
        n = s.rows // tiles * s.t
        offs[i][0] = at
        at += _align16(4 * n)
        if s.has_pad:
            offs[i][1] = at
            at += _align16(elem_bytes * n)
        if s.diag is not None:
            offs[i][2] = at
            at += _align16(elem_bytes * n)
        return at

    start = off
    for i, s in enumerate(steps[1:], 1):
        if periodic[i]:
            off = tables(i, s, off)
    shared = (start, off - start)
    perms = tuple(w_perm(s, elem_bytes, i == 0)
                  for i, s in enumerate(steps))
    for i, s in enumerate(steps[1:], 1):
        offs[i][3] = off
        off += _align16(elem_bytes * s.groups * s.t * s.n_out)
    own = 0
    for i, s in enumerate(steps[1:], 1):
        if not periodic[i]:
            own = tables(i, s, own)
    buf = max((s.n_elems // tiles for s in steps[:-1]), default=0)
    return ChainLayout(shared, tuple(tuple(o) for o in offs), off, own, buf,
                       slots, _slot_bytes(off, own, buf, slots), perms)


def shared_bytes(steps: Sequence[SubStep], tiles: int, tiles_per_cta: int,
                 periodic: Sequence[bool], elem_bytes: int = 4) -> int:
    """Dynamic shared memory of one block of the chain kernel with
    ``tiles_per_cta`` slots (:func:`chain_layout`)."""
    return chain_layout(steps, tiles, tiles_per_cta, periodic,
                        elem_bytes).total


@dataclasses.dataclass(eq=False)
class ChainSegment:
    """Sub-steps run by one launch: ``tiles`` tiles a batch row, at most
    ``tiles_per_cta`` of them in a block at once (its slots, over the
    launch's flat list of (batch row, tile) pairs), per sub-step whether
    one tile's tables serve all (``periodic``; then only the first tile's
    rows go to the card), and per sub-step its ``(idx, pads, scale)`` in
    the kernel's form, every tile's rows, as numpy arrays.  A segment of
    one sub-step runs on the per-step kernels."""
    steps: Tuple[SubStep, ...]
    tiles: int
    tiles_per_cta: int
    periodic: Tuple[bool, ...]
    tables: list = dataclasses.field(repr=False)
    _device: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def launch(self) -> str:
        """The wrapper whose kernel runs this segment."""
        if len(self.steps) > 1:
            return "shuffle_gemm_chain"
        return ("shuffle_gemm_blocks" if self.steps[0].groups == 1
                else "shuffle_gemm_grouped_blocks")

    @property
    def slot_rows(self) -> int:
        """Rows a tile of the median sub-step: a block takes one thread a
        row of its slots' tiles of it (wider sub-steps loop; a block of
        more warps pays more at each sub-step's barrier), in whole warps,
        32 to 512, at least one a sub-step (each copies one
        descriptor)."""
        rows = sorted(s.rows // self.tiles for s in self.steps)
        return rows[len(rows) // 2]

    def row_spans(self, i: int):
        """Sub-step ``i``'s plain ``(rows, t)`` table as
        :class:`~repro_torch.kernels.shuffle_gemm.tiling.RowSpans` (the
        staged blocks body's spans), built once."""
        from .tiling import RowSpans
        key = ("spans", i)
        hit = self._device.get(key)
        if hit is None:
            s = self.steps[i]
            hit = self._device[key] = RowSpans(
                s.idx, np.asarray(s.plan.pad_values).reshape(s.rows, s.t),
                None if s.diag is None else
                np.asarray(s.diag).reshape(s.rows, s.t))
        return hit

    @functools.cached_property
    def swz(self) -> Tuple[bool, ...]:
        """Per sub-step whether the kernel swizzles its buffered output
        (:func:`swizzle`): every sub-step but the last whose tile holds a
        whole number of 32-float blocks."""
        return tuple(i + 1 < len(self.steps)
                     and (s.n_elems // self.tiles) % 32 == 0
                     for i, s in enumerate(self.steps))

    @functools.cached_property
    def pairs(self) -> Tuple[bool, ...]:
        """Per sub-step whether every row of a butterfly (t 4, n_out 4)
        after the first reads two pairs ``(i, i + 1)``, ``i`` even, of the
        buffer (no PAD): the kernel then gathers them by two 8-byte
        loads."""
        out = [False]
        for s, (idx, _, _) in zip(self.steps[1:], self.tables[1:]):
            idx = np.asarray(idx)
            out.append(bool(
                s.t == 4 and s.n_out == 4 and (idx[:, [0, 2]] >= 0).all()
                and (idx[:, [0, 2]] % 2 == 0).all()
                and (idx[:, [1, 3]] == idx[:, [0, 2]] + 1).all()))
        return tuple(out)

    @functools.cached_property
    def zero_pads0(self) -> bool:
        """Whether every PAD value of the first sub-step (times its scale,
        finite there) is 0: the kernel then reads no PAD table for it."""
        idx, pads, scale = self.tables[0]
        at = np.asarray(idx) < 0
        v = np.asarray(pads, np.float64)[at]
        if scale is not None:
            v = v * np.asarray(scale, np.float64)[at]
        return bool(np.isfinite(v).all() and (v == 0).all())

    def report(self) -> dict:
        return {"steps": [s.name for s in self.steps],
                "launch": self.launch, "tiles": self.tiles,
                "tile_floats": int(self.steps[-1].n_elems // self.tiles),
                "tiles_per_cta": self.tiles_per_cta,
                "periodic": [bool(p) for p in self.periodic],
                "shared_bytes": int(shared_bytes(self.steps, self.tiles,
                                                 self.tiles_per_cta,
                                                 self.periodic))}

    def device_tables(self, device, dtype):
        """The segment on ``device`` for inputs of ``dtype``, built once
        per (device, dtype): ``(kern, plain)``.  ``kern`` holds what the
        chain kernel takes: ``first``, sub-step 0's ``(idx, pads,
        scale)`` (``scale`` None without a diag); ``shared``, the
        periodic sub-steps' tables packed in the :func:`chain_layout`
        order (uint8); ``own``, the other sub-steps' tables, one packed
        row a tile (uint8, ``(tiles, own_bytes)``); and ``layout``.  A
        sub-step's indices into a swizzled output (:attr:`swz`) are
        packed swizzled.
        ``plain`` is per sub-step the ``(rows, t)``
        ``(idx, pads, scale)`` of the per-step kernels."""
        import torch
        key = (str(torch.device(device)), dtype)
        hit = self._device.get(key)
        if hit is None:
            def put(a, dt):
                return None if a is None else torch.as_tensor(
                    np.ascontiguousarray(a), device=device).to(dt)

            def raw(a, dt):
                return torch.as_tensor(np.ascontiguousarray(a)).to(
                    dt).contiguous().view(torch.uint8).numpy().ravel()

            lay = chain_layout(self.steps, self.tiles, self.tiles_per_cta,
                               self.periodic,
                               torch.empty((), dtype=dtype).element_size())
            shared = np.zeros(lay.shared[1], np.uint8)
            own = np.zeros((self.tiles, lay.own_bytes), np.uint8)
            for i, s in enumerate(self.steps[1:], 1):
                rows = s.rows // self.tiles
                idx, pads, scale = self.tables[i]
                if self.swz[i - 1]:            # as the step before wrote
                    idx = swizzle(idx)
                for off, a, dt in zip(lay.steps[i][:3], (idx, pads, scale),
                                      (torch.int32, dtype, dtype)):
                    if off < 0:
                        continue
                    if self.periodic[i]:
                        b = raw(a[:rows], dt)
                        o = off - lay.shared[0]
                        shared[o:o + b.size] = b
                        continue
                    b = raw(a, dt).reshape(self.tiles, -1)
                    own[:, off:off + b.shape[1]] = b
            idx, pads, scale = self.tables[0]
            kern = {"first": (put(idx, torch.int32), put(pads, dtype),
                              put(scale, dtype)),
                    "shared": put(shared, torch.uint8),
                    "own": put(own, torch.uint8), "layout": lay}
            plain = [(put(s.idx, torch.int32),
                      put(np.asarray(s.plan.pad_values).reshape(s.rows, s.t),
                          dtype),
                      None if s.diag is None else put(
                          np.asarray(s.diag).reshape(s.rows, s.t), dtype))
                     for s in self.steps]
            hit = self._device[key] = (kern, plain)
        return hit


def _tiles_per_cta(steps, tiles, periodic) -> int:
    """Slots a block: as many tiles as hold :data:`MAX_BLOCK_ROWS` rows
    of the widest sub-step (at most :data:`MAX_SLOTS`, at least one),
    within shared memory."""
    rows = max(s.rows // tiles for s in steps)
    slots = max(1, min(MAX_SLOTS, MAX_BLOCK_ROWS // rows))
    while slots > 1 and shared_bytes(steps, tiles, slots,
                                     periodic) > SHARED_BYTES:
        slots -= 1
    return slots


def _segment(steps: Sequence[SubStep]) -> ChainSegment:
    tiles = best_tiles(steps) if len(steps) > 1 else 1
    tables = _rebased(steps, tiles)
    periodic = tuple(p for *_, p in tables)
    tpc = _tiles_per_cta(steps, tiles, periodic) if len(steps) > 1 else 1
    return ChainSegment(tuple(steps), tiles, tpc, periodic,
                        [t[:3] for t in tables])


def _fits(steps: Sequence[SubStep]) -> bool:
    tiles = best_tiles(steps)
    periodic = tuple(p for *_, p in _rebased(steps, tiles))
    return shared_bytes(steps, tiles, 1, periodic) <= SHARED_BYTES


def segment_chain(steps: Sequence[SubStep]) -> List[ChainSegment]:
    """Cut a chain into segments, greedily from the front (see the
    module docstring).  Raises ``ValueError`` where sub-step s + 1 does
    not read a vector of sub-step s's output length."""
    for prev, s in zip(steps, steps[1:]):
        if int(s.plan.gather_idx.max(initial=-1)) >= prev.n_elems:
            raise ValueError(f"{s.name} reads past the {prev.n_elems} "
                             f"outputs of {prev.name}")
    segments, a = [], 0
    while a < len(steps):
        b = a + 1
        while b < len(steps) and b - a < MAX_SUBSTEPS \
                and _fits(steps[a:b + 1]):
            b += 1
        segments.append(_segment(steps[a:b]))
        a = b
    return segments
