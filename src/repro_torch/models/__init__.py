"""Models of the port (the counterpart of ``repro.models``): layers, the
pattern-grouped transformer (dense, MoE, RG-LRU hybrid and xLSTM
blocks), the Whisper encoder-decoder and the zoo's bundle API."""

from .zoo import ModelBundle, get_model

__all__ = ["ModelBundle", "get_model"]
