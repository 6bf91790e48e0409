"""Training runtime of the port (the counterpart of ``repro.runtime``'s
training half)."""

from .fault_tolerance import StepMonitor, TrainLoop

__all__ = ["StepMonitor", "TrainLoop"]
