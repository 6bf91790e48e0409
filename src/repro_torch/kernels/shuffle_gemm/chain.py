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
block of the kernel then runs one tile (or a few) of one batch row from
start to end with no value from another block; the first sub-step may
read anywhere in the segment's input, which lies in device memory.
The tiling kept is the valid one with the most tiles: the smallest
buffers and the most blocks.  For the Fig-9 STFT (frame 256, 31 frames
a batch row) that is 31 tiles of 512 floats, one a frame.

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
shared memory; the kernel takes its offsets as given.  The tables of
every sub-step after the first are packed on the host, in that layout,
into two device buffers: the periodic sub-steps' (one copy, read by
every block) and the others' (one slice a block).  A block stages each
buffer by one contiguous copy, and each operand by one more: a few long
runs of 16-byte copies, where a copy a table row made the staging a
chain of short dependent steps per thread.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...core.fabric import PAD, ShufflePlan

__all__ = ["SubStep", "ChainSegment", "ChainLayout", "segment_chain",
           "best_tiles", "chain_layout", "shared_bytes", "SHARED_BYTES",
           "MAX_SUBSTEPS", "MIN_BLOCK_ROWS"]

SHARED_BYTES = 227 * 1024     # a block's opt-in shared memory on sm_90
MAX_SUBSTEPS = 32             # kMaxSub in csrc/shuffle_gemm.cu
MIN_BLOCK_ROWS = 128          # rows a block takes before it takes more tiles
STEP_BYTES = 72               # sizeof(Step) in csrc/shuffle_gemm.cu


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


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
    memory, in bytes: the sub-steps' descriptors at 0, two float32
    buffers of ``buf_floats`` at ``off_buf``, the periodic sub-steps'
    tables (``shared``: offset, bytes) and the others' for the block's
    tiles (``own``), then the operands; per sub-step ``(idx, pad, scale,
    w)`` offsets (-1 where it has none; sub-step 0 reads its own from
    device memory).  Every offset is a multiple of 16."""
    off_buf: int
    buf_floats: int
    shared: Tuple[int, int]
    own: Tuple[int, int]
    steps: Tuple[Tuple[int, int, int, int], ...]
    total: int


def chain_layout(steps: Sequence[SubStep], tiles: int, tiles_per_cta: int,
                 periodic: Sequence[bool], elem_bytes: int = 4
                 ) -> ChainLayout:
    """The shared-memory layout of one block (see :class:`ChainLayout`):
    descriptors (:data:`STEP_BYTES` each); two buffers of the block's
    tiles of the largest buffered output (every sub-step's but the
    last); then per sub-step after the first, periodic ones first, its
    index table, its PAD values when it has a PAD entry and its scale
    when it has one (``elem_bytes`` a value; one tile's rows when
    periodic, the block's tiles' rows else); then each operand.  Each
    region is rounded up to 16 bytes."""
    off = _align16(STEP_BYTES * len(steps))
    off_buf = off
    buf = tiles_per_cta * max((s.n_elems // tiles for s in steps[:-1]),
                              default=0)
    off += 2 * _align16(4 * buf)
    offs = [[-1, -1, -1, -1] for _ in steps]
    regions = []
    for own in (False, True):
        start = off
        for i, s in enumerate(steps[1:], 1):
            if periodic[i] == own:
                continue
            n = s.rows // tiles * (tiles_per_cta if own else 1) * s.t
            offs[i][0] = off
            off += _align16(4 * n)
            if s.has_pad:
                offs[i][1] = off
                off += _align16(elem_bytes * n)
            if s.diag is not None:
                offs[i][2] = off
                off += _align16(elem_bytes * n)
        regions.append((start, off - start))
    for i, s in enumerate(steps[1:], 1):
        offs[i][3] = off
        off += _align16(elem_bytes * s.groups * s.t * s.n_out)
    return ChainLayout(off_buf, buf, regions[0], regions[1],
                       tuple(tuple(o) for o in offs), off)


def shared_bytes(steps: Sequence[SubStep], tiles: int, tiles_per_cta: int,
                 periodic: Sequence[bool], elem_bytes: int = 4) -> int:
    """Dynamic shared memory of one block of the chain kernel
    (:func:`chain_layout`)."""
    return chain_layout(steps, tiles, tiles_per_cta, periodic,
                        elem_bytes).total


@dataclasses.dataclass(eq=False)
class ChainSegment:
    """Sub-steps run by one launch: ``tiles`` tiles a batch row,
    ``tiles_per_cta`` of them a block (a divisor of ``tiles``), per
    sub-step whether one tile's tables serve all (``periodic``; then
    only the first tile's rows go to the card), and per sub-step its
    ``(idx, pads, scale)`` in the kernel's form, every tile's rows, as
    numpy arrays.  A segment of one sub-step runs on the per-step
    kernels."""
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
    def threads(self) -> int:
        """Threads a block: one a row of the block's tiles of the median
        sub-step (wider sub-steps loop; a block of more warps pays more
        at each sub-step's barrier), in whole warps, 32 to 512 (at least
        one a sub-step: each copies one descriptor)."""
        rows = sorted(s.rows // self.tiles for s in self.steps)
        rows = rows[len(rows) // 2] * self.tiles_per_cta
        return min(512, max(32, -(-rows // 32) * 32))

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
        row a block's tiles (uint8, ``(tiles / tiles_per_cta, bytes)``);
        and ``layout``.  ``plain`` is per sub-step the ``(rows, t)``
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
            tpc = self.tiles_per_cta
            shared = np.zeros(lay.shared[1], np.uint8)
            own = np.zeros((self.tiles // tpc, lay.own[1]), np.uint8)
            for i, s in enumerate(self.steps[1:], 1):
                rows = s.rows // self.tiles * (1 if self.periodic[i] else tpc)
                for off, a, dt in zip(lay.steps[i][:3], self.tables[i],
                                      (torch.int32, dtype, dtype)):
                    if off < 0:
                        continue
                    if self.periodic[i]:
                        b = raw(a[:rows], dt)
                        o = off - lay.shared[0]
                        shared[o:o + b.size] = b
                        continue
                    for q in range(self.tiles // tpc):
                        b = raw(a[q * rows:(q + 1) * rows], dt)
                        o = off - lay.own[0]
                        own[q, o:o + b.size] = b
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
    """The fewest tiles a block (a divisor of ``tiles``) that give it
    :data:`MIN_BLOCK_ROWS` rows of its widest sub-step, within shared
    memory."""
    rows = max(s.rows // tiles for s in steps)
    divisors = [d for d in range(1, tiles + 1) if tiles % d == 0]
    fit = [d for d in divisors
           if shared_bytes(steps, tiles, d, periodic) <= SHARED_BYTES]
    return next((d for d in fit if d * rows >= MIN_BLOCK_ROWS), fit[-1])


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
