"""Optimizers of the port: AdamW as plain functions on params trees (the
counterpart of the JAX package's ``repro.optim.adamw``)."""

from .adamw import (AdamWState, adamw_init, adamw_update,  # noqa: F401
                    cosine_schedule, global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]
