"""Models of the port (the counterpart of ``repro.models``): the dense
decoder family — layers, the pattern-grouped transformer and the zoo's
bundle API.  MoE, RG-LRU, xLSTM and Whisper are later slices (ROADMAP
Queue 1 item 6)."""

from .zoo import ModelBundle, get_model

__all__ = ["ModelBundle", "get_model"]
