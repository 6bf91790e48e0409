"""Precision helpers of the PyTorch port.

Only the block-circulant lowering of ``SignalGraph.dnn_circulant`` is
here so far (plain numpy plan construction, see
:mod:`repro_torch.precision.circulant`); calibration and the width
solver, which int-route array passes through ``bitserial_mm``, belong to
the precision slice of the port.
"""

from .circulant import (circulant_gather_plan, circulant_init,  # noqa: F401
                        circulant_matrix, circulant_operand,
                        circulant_post_plan, circulant_project,
                        circulant_spectra, circulant_taps)

__all__ = [
    "circulant_init", "circulant_operand", "circulant_taps",
    "circulant_matrix", "circulant_project", "circulant_spectra",
    "circulant_gather_plan", "circulant_post_plan",
]
