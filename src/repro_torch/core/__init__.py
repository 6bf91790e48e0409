"""SigDLA core: the paper's contribution as composable PyTorch modules.

- shuffle_ir / shuffle_compiler: the programmable shuffling-fabric ISA
  (faithful functional + cycle semantics).
- fabric: compiled shuffle plans and their execution on a torch device.
- signal_mapping: FFT / FIR / DCT / DWT -> shuffle plans + GEMMs.
- bitwidth: the variable-bitwidth (4/8/16-bit) computing-array arithmetic.
- perf_model: cycle/energy/area model reproducing the paper's evaluation.
- exec_ir: the executable-program IR of a compiled SignalGraph.
"""

from . import (bitwidth, exec_ir, fabric, perf_model, shuffle_compiler,
               shuffle_ir, signal_mapping)
from .fabric import PAD, ShufflePlan, apply_plan

__all__ = ["bitwidth", "exec_ir", "fabric", "perf_model",
           "shuffle_compiler", "shuffle_ir", "signal_mapping", "PAD",
           "ShufflePlan", "apply_plan"]
