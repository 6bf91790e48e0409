"""Optimizers of the port: AdamW as plain functions on params trees, and
int8 gradient compression with error feedback (the counterpart of the
JAX package's ``repro.optim``)."""

from .adamw import (AdamWState, adamw_init, adamw_update,  # noqa: F401
                    cosine_schedule, global_norm)
from .compression import (allreduce_compressed, compress_int8,  # noqa: F401
                          decompress_int8, ef_compress_update, ef_init)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "compress_int8", "decompress_int8",
           "ef_compress_update", "ef_init", "allreduce_compressed"]
