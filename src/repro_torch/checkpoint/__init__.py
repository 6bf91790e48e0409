from .checkpointer import Checkpointer, latest_step

__all__ = ["Checkpointer", "latest_step"]
