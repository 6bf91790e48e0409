"""Fault-tolerant runtime of the port (the counterpart of
``repro.runtime``): the training loop and the supervised stream, and the
pipeline schedule over a mesh dim (``runtime.pipeline``)."""

from .fault_tolerance import (DeviceLoss, StepMonitor, StreamSupervisor,
                              TrainLoop)
from .pipeline import pipeline_bubble_fraction, spmd_pipeline

__all__ = ["StepMonitor", "TrainLoop", "StreamSupervisor", "DeviceLoss",
           "pipeline_bubble_fraction", "spmd_pipeline"]
