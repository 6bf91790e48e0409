"""Fault-tolerant runtime of the port (the counterpart of
``repro.runtime``): the training loop and the supervised stream."""

from .fault_tolerance import (DeviceLoss, StepMonitor, StreamSupervisor,
                              TrainLoop)

__all__ = ["StepMonitor", "TrainLoop", "StreamSupervisor", "DeviceLoss"]
