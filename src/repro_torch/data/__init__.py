"""Synthetic data of the port (the counterpart of ``repro.data``)."""

from .pipeline import SignalStream

__all__ = ["SignalStream"]
