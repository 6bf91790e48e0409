"""Faithful functional + cycle model of the SigDLA shuffling fabric ISA.

Implements the five instructions of the paper (Fig. 5):

  rd-buf   (bank-start, bank-offset, length)          memory -> BCIF buffer
  wr-buf   (bank-start, bank-offset, length)          DPU output -> memory
  ctrl-bitwidth (width)                               4 / 8 / 16
  ctrl-shuffling (unit-num, sel-code, split-code, finish-flag)
  ctrl-padding  (position, value)

and the micro-architecture of §V-B:

  * BCIF: a 16-word (64-bit each) data buffer window fed by `rd-buf`.
  * DSU : 16 shuffle units.  Unit ``u`` selects one of the 16 buffered 64-bit
    words (``sel-code``), splits it into 16 nibbles, picks nibble
    ``split-code`` and contributes it as nibble ``u`` of the output word.
  * DPU : overwrites configured element positions of the output word with
    constants.  At bitwidth 4/8/16 a 64-bit word has 16/8/4 element
    positions.  (The paper's text swaps the value widths — "16-bit, 8-bit,
    4-bit in order" — which is inconsistent with a 64-bit word; we use
    value-width == element-width, the only self-consistent reading.)

Everything here is plain numpy executed at *compile/trace time* — it is the
oracle for the JAX fast path (`core/fabric.py`) and the cycle source for the
paper-claims perf model (`core/perf_model.py`).  Data is modelled at nibble
granularity: a 64-bit word is a vector of 16 uint8 nibbles (values 0..15),
little-endian (nibble 0 = bits [3:0]).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

WORD_NIBBLES = 16          # 64-bit word = 16 nibbles
BCIF_WORDS = 16            # DSU selects among 16 buffered words
N_UNITS = 16               # 16 shuffle units -> one 64-bit output word/pass
VALID_WIDTHS = (4, 8, 16)


# --------------------------------------------------------------------------
# Instruction set
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RdBuf:
    """Load ``length`` consecutive 64-bit words from memory word-address
    ``bank_start * bank_words + bank_offset`` into the BCIF buffer, appending
    at the current fill cursor (wrapping at 16)."""
    bank_start: int
    bank_offset: int
    length: int


@dataclasses.dataclass(frozen=True)
class WrBuf:
    """Store ``length`` output words (produced by shuffle passes since the
    last WrBuf) back to memory at the given word address."""
    bank_start: int
    bank_offset: int
    length: int


@dataclasses.dataclass(frozen=True)
class CtrlBitwidth:
    width: int  # 4 | 8 | 16

    def __post_init__(self):
        if self.width not in VALID_WIDTHS:
            raise ValueError(f"bitwidth must be one of {VALID_WIDTHS}")


@dataclasses.dataclass(frozen=True)
class CtrlShuffling:
    unit_num: int    # which of the 16 shuffle units to configure
    sel_code: int    # which buffered 64-bit word to read      (0..15)
    split_code: int  # which nibble of that word to emit       (0..15)
    finish_flag: bool = False  # last config of the group -> fire a pass

    def __post_init__(self):
        if not (0 <= self.unit_num < N_UNITS):
            raise ValueError("unit_num out of range")
        if not (0 <= self.sel_code < BCIF_WORDS):
            raise ValueError("sel_code out of range")
        if not (0 <= self.split_code < WORD_NIBBLES):
            raise ValueError("split_code out of range")


@dataclasses.dataclass(frozen=True)
class CtrlPadding:
    position: int  # element position within the output word (width-dependent)
    value: int     # constant, width bits (two's complement for signed users)
    enable: bool = True


Instruction = Union[RdBuf, WrBuf, CtrlBitwidth, CtrlShuffling, CtrlPadding]


@dataclasses.dataclass
class Program:
    instructions: List[Instruction] = dataclasses.field(default_factory=list)

    def append(self, instr: Instruction) -> None:
        self.instructions.append(instr)

    def extend(self, instrs: Iterable[Instruction]) -> None:
        self.instructions.extend(instrs)

    def __len__(self) -> int:
        return len(self.instructions)


# --------------------------------------------------------------------------
# Nibble <-> integer packing helpers
# --------------------------------------------------------------------------

def ints_to_nibbles(values: np.ndarray, width: int) -> np.ndarray:
    """Pack integers of ``width`` bits into a flat little-endian nibble array."""
    if width not in VALID_WIDTHS:
        raise ValueError("bad width")
    values = np.asarray(values)
    k = width // 4
    u = values.astype(np.int64) & ((1 << width) - 1)  # two's complement view
    nibbles = np.empty(values.size * k, dtype=np.uint8)
    for i in range(k):
        nibbles[i::k] = ((u >> (4 * i)) & 0xF).astype(np.uint8).ravel()
    return nibbles


def nibbles_to_ints(nibbles: np.ndarray, width: int, signed: bool = True) -> np.ndarray:
    """Inverse of :func:`ints_to_nibbles`."""
    k = width // 4
    nibbles = np.asarray(nibbles, dtype=np.int64)
    if nibbles.size % k:
        raise ValueError("nibble count not a multiple of element size")
    out = np.zeros(nibbles.size // k, dtype=np.int64)
    for i in range(k):
        out |= nibbles[i::k] << (4 * i)
    if signed:
        sign = 1 << (width - 1)
        out = (out ^ sign) - sign
    return out


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CycleReport:
    rd_cycles: int = 0
    wr_cycles: int = 0
    config_cycles: int = 0
    shuffle_cycles: int = 0

    @property
    def total(self) -> int:
        return self.rd_cycles + self.wr_cycles + self.config_cycles + self.shuffle_cycles


class ShuffleEngine:
    """Executes a :class:`Program` against a word-addressed nibble memory.

    ``memory`` is a flat uint8 nibble array whose length is a multiple of 16
    (an integral number of 64-bit words).  ``bank_words`` sets the bank size
    used by rd/wr address generation.
    """

    def __init__(self, memory: np.ndarray, bank_words: int = 256):
        memory = np.asarray(memory, dtype=np.uint8)
        if memory.ndim != 1 or memory.size % WORD_NIBBLES:
            raise ValueError("memory must be a flat nibble array of whole words")
        self.memory = memory.copy()
        self.bank_words = bank_words
        self.buffer = np.zeros((BCIF_WORDS, WORD_NIBBLES), dtype=np.uint8)
        self._fill = 0
        self.sel = np.zeros(N_UNITS, dtype=np.int64)
        self.split = np.zeros(N_UNITS, dtype=np.int64)
        self.width = 4
        self._padding: List[Tuple[int, int]] = []
        self._out_queue: List[np.ndarray] = []
        self.cycles = CycleReport()

    # -- address helpers ---------------------------------------------------
    def _word(self, addr: int) -> np.ndarray:
        lo = addr * WORD_NIBBLES
        if lo < 0 or lo + WORD_NIBBLES > self.memory.size:
            raise IndexError(f"word address {addr} out of range")
        return self.memory[lo:lo + WORD_NIBBLES]

    # -- semantics ----------------------------------------------------------
    def _rd_buf(self, ins: RdBuf) -> None:
        addr = ins.bank_start * self.bank_words + ins.bank_offset
        for w in range(ins.length):
            self.buffer[(self._fill + w) % BCIF_WORDS] = self._word(addr + w)
        self._fill = (self._fill + ins.length) % BCIF_WORDS
        self.cycles.rd_cycles += ins.length

    def _fire_pass(self) -> None:
        out = np.empty(WORD_NIBBLES, dtype=np.uint8)
        for u in range(N_UNITS):
            out[u] = self.buffer[self.sel[u], self.split[u]]
        # DPU: element-granular constant padding.
        k = self.width // 4
        for pos, val in self._padding:
            if pos < 0 or (pos + 1) * k > WORD_NIBBLES:
                raise IndexError("padding position out of range for bitwidth")
            out[pos * k:(pos + 1) * k] = ints_to_nibbles(
                np.array([val]), self.width)
        self._out_queue.append(out)
        self.cycles.shuffle_cycles += 1

    def _wr_buf(self, ins: WrBuf) -> None:
        if len(self._out_queue) < ins.length:
            raise RuntimeError("wr-buf length exceeds produced output words")
        addr = ins.bank_start * self.bank_words + ins.bank_offset
        for w in range(ins.length):
            word = self._out_queue.pop(0)
            lo = (addr + w) * WORD_NIBBLES
            self.memory[lo:lo + WORD_NIBBLES] = word
        self.cycles.wr_cycles += ins.length

    def run(self, program: Program) -> np.ndarray:
        for ins in program.instructions:
            if isinstance(ins, RdBuf):
                self._rd_buf(ins)
            elif isinstance(ins, WrBuf):
                self._wr_buf(ins)
            elif isinstance(ins, CtrlBitwidth):
                self.width = ins.width
                self.cycles.config_cycles += 1
            elif isinstance(ins, CtrlShuffling):
                self.sel[ins.unit_num] = ins.sel_code
                self.split[ins.unit_num] = ins.split_code
                self.cycles.config_cycles += 1
                if ins.finish_flag:
                    self._fire_pass()
            elif isinstance(ins, CtrlPadding):
                if ins.enable:
                    self._padding.append((ins.position, ins.value))
                else:
                    self._padding = []
                self.cycles.config_cycles += 1
            else:  # pragma: no cover - defensive
                raise TypeError(f"unknown instruction {ins!r}")
        return self.memory


def run_program(memory: np.ndarray, program: Program,
                bank_words: int = 256) -> Tuple[np.ndarray, CycleReport]:
    eng = ShuffleEngine(memory, bank_words=bank_words)
    out = eng.run(program)
    return out, eng.cycles
