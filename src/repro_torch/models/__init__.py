"""Models of the port (the counterpart of ``repro.models``): layers, the
pattern-grouped transformer (dense, MoE, RG-LRU hybrid and xLSTM
blocks), the Whisper encoder-decoder, the zoo's bundle API and the
sharding rules (``repro_torch.models.sharding``, imported from there as
the JAX package's ``repro.models.sharding`` is)."""

from .zoo import ModelBundle, batch_pspec, get_model

__all__ = ["ModelBundle", "get_model", "batch_pspec"]
