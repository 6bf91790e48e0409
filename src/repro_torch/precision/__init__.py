"""SigQuant: calibration-driven reconfigurable precision (paper §IV), in
PyTorch.

The paper's computing array reconfigures between 4/8/16-bit operands;
this package decides *which* widths each array pass of a compiled
SignalGraph gets, automatically:

* :func:`calibrate` — observer pass over representative traffic,
  recording per-step activation/weight ranges, exact-int overflow
  range-proofs, local quantization error, and per-output reach into a
  :class:`CalibrationRecord`;
* :func:`solve_widths` / :func:`auto_policy` — greedy narrow-then-repair
  over the throughput-ordered :data:`LADDER`, emitting an
  overflow-guarded :class:`~repro_torch.signal.backends.PrecisionPolicy`
  that meets a per-output error budget on held-out batches;
* :mod:`~repro_torch.precision.circulant` — block-circulant lowering of
  the ``dnn`` stage (``SignalGraph.dnn_circulant``) so DL matmuls run
  through the same shuffle-GEMM + ``bitserial_mm`` path as the DSP
  stages.

Serve a calibrated program with ``SignalService(backend="hopper",
precision=policy)`` — the policy is part of the backend's compile-cache
key, so offline and bucketed execution share one lowering.
"""

from .calibration import (LADDER, CalibrationRecord, StepStats,  # noqa: F401
                          calibrate)
from .circulant import (circulant_gather_plan, circulant_init,  # noqa: F401
                        circulant_matrix, circulant_operand,
                        circulant_post_plan, circulant_project,
                        circulant_spectra, circulant_taps)
from .solver import auto_policy, policy_errors, solve_widths  # noqa: F401

__all__ = [
    "LADDER", "CalibrationRecord", "StepStats", "calibrate",
    "solve_widths", "auto_policy", "policy_errors",
    "circulant_init", "circulant_operand", "circulant_taps",
    "circulant_matrix", "circulant_project", "circulant_spectra",
    "circulant_gather_plan", "circulant_post_plan",
]
