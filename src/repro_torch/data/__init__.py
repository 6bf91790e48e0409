"""Synthetic data of the port (the counterpart of ``repro.data``)."""

from .pipeline import SignalStream, TokenStream

__all__ = ["TokenStream", "SignalStream"]
