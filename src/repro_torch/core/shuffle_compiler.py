"""Compile high-level shuffle plans into SigDLA shuffle-ISA programs.

A :class:`~repro_torch.core.fabric.ShufflePlan` describes, at element granularity,
``out[i] = in[gather_idx[i]]`` with optional constant padding
(``gather_idx[i] == PAD``).  This module lowers a plan to the five-opcode
instruction stream of :mod:`repro_torch.core.shuffle_ir`, word by word, exactly as
the hardware sequencer of the paper would:

  per output 64-bit word:
      rd-buf   x R   (one per contiguous run of needed source words)
      ctrl-shuffling x 16   (last carries finish-flag -> fires the pass)
      ctrl-padding  (clear + one per padded element in this word)
      wr-buf   x 1

The compiled program is *proven equivalent* to the plan by the property
tests in tests/test_fabric.py, and its instruction counts feed the cycle
model (`core/perf_model.py`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import shuffle_ir as ir

PAD = -1


def _element_nibble_sources(gather_idx: np.ndarray, width: int) -> np.ndarray:
    """Source nibble index for every output nibble (PAD elements -> -1)."""
    k = width // 4
    n_out = gather_idx.shape[0]
    src = np.empty(n_out * k, dtype=np.int64)
    for j in range(k):
        src[j::k] = np.where(gather_idx == PAD, -1, gather_idx * k + j)
    return src


def compile_plan(gather_idx: np.ndarray,
                 pad_values: np.ndarray,
                 width: int,
                 src_word_addr: int,
                 dst_word_addr: int,
                 bank_words: int = 256) -> ir.Program:
    """Lower a gather/pad plan to an instruction stream.

    ``gather_idx``: (n_out,) element indices into the source region, PAD(-1)
    where the DPU supplies ``pad_values``.  ``n_out * width/4`` must be a
    multiple of 16 (whole output words) — callers pad plans to word
    boundaries (see fabric.pad_plan_to_word).
    """
    gather_idx = np.asarray(gather_idx, dtype=np.int64)
    pad_values = np.asarray(pad_values, dtype=np.int64)
    k = width // 4
    if (gather_idx.size * k) % ir.WORD_NIBBLES:
        raise ValueError("plan does not fill whole output words; pad it first")
    elems_per_word = ir.WORD_NIBBLES // k
    n_words = gather_idx.size // elems_per_word

    nib_src = _element_nibble_sources(gather_idx, width)

    prog = ir.Program()
    prog.append(ir.CtrlBitwidth(width))
    fill = 0  # mirror of the engine's BCIF fill cursor
    for w in range(n_words):
        lo = w * ir.WORD_NIBBLES
        word_src = nib_src[lo:lo + ir.WORD_NIBBLES]          # nibble sources
        need = sorted({int(s) // ir.WORD_NIBBLES for s in word_src if s >= 0})
        if len(need) > ir.BCIF_WORDS:
            raise ValueError("output word draws from >16 source words")

        # rd-buf: contiguous runs of needed source words.
        slot_of = {}
        runs: List[Tuple[int, int]] = []
        for sw in need:
            if runs and sw == runs[-1][0] + runs[-1][1]:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((sw, 1))
        for start, length in runs:
            bank, off = divmod(src_word_addr + start, bank_words)
            prog.append(ir.RdBuf(bank, off, length))
            for i in range(length):
                slot_of[start + i] = (fill + i) % ir.BCIF_WORDS
            fill = (fill + length) % ir.BCIF_WORDS

        # ctrl-padding: reset, then configure this word's pads.
        prog.append(ir.CtrlPadding(0, 0, enable=False))
        word_elems = gather_idx[w * elems_per_word:(w + 1) * elems_per_word]
        word_pads = pad_values[w * elems_per_word:(w + 1) * elems_per_word]
        for e in range(elems_per_word):
            if word_elems[e] == PAD:
                mask = (1 << width) - 1
                prog.append(ir.CtrlPadding(e, int(word_pads[e]) & mask))

        # ctrl-shuffling: one per unit; finish-flag on the last fires a pass.
        for u in range(ir.N_UNITS):
            s = word_src[u]
            if s < 0:                       # padded nibble — source is dont-care
                sel, split = 0, 0
            else:
                sel = slot_of[int(s) // ir.WORD_NIBBLES]
                split = int(s) % ir.WORD_NIBBLES
            prog.append(ir.CtrlShuffling(u, sel, split,
                                         finish_flag=(u == ir.N_UNITS - 1)))

        bank, off = divmod(dst_word_addr + w, bank_words)
        prog.append(ir.WrBuf(bank, off, 1))
    return prog


def run_plan_via_isa(x: np.ndarray,
                     gather_idx: np.ndarray,
                     pad_values: np.ndarray,
                     width: int) -> Tuple[np.ndarray, ir.CycleReport]:
    """Execute a plan through the full ISA path (compile -> ShuffleEngine).

    Returns the output elements and the cycle report.  This is the oracle
    used to validate the JAX fast path in core/fabric.py.
    """
    x = np.asarray(x)
    k = width // 4
    n_src_words = -(-x.size * k // ir.WORD_NIBBLES)
    n_out_words = gather_idx.size * k // ir.WORD_NIBBLES
    src_nib = ir.ints_to_nibbles(x, width)
    src_nib = np.pad(src_nib, (0, n_src_words * ir.WORD_NIBBLES - src_nib.size))
    memory = np.concatenate(
        [src_nib, np.zeros(n_out_words * ir.WORD_NIBBLES, dtype=np.uint8)])
    prog = compile_plan(gather_idx, pad_values, width,
                        src_word_addr=0, dst_word_addr=n_src_words)
    out_mem, cycles = ir.run_program(memory, prog)
    out_nib = out_mem[n_src_words * ir.WORD_NIBBLES:]
    return ir.nibbles_to_ints(out_nib, width, signed=True), cycles
