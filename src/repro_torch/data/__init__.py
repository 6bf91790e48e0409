"""Synthetic data of the port (the counterpart of ``repro.data``)."""

from .pipeline import SignalStream, TokenStream, make_batch_iterator

__all__ = ["TokenStream", "SignalStream", "make_batch_iterator"]
