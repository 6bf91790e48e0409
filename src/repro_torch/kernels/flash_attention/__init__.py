from .kernel import (flash_attention_hopper, launch_counts,  # noqa: F401
                     reset_launch_counts)
from .ops import flash_attention
from .ref import ref_attention

__all__ = ["flash_attention", "flash_attention_hopper", "ref_attention",
           "launch_counts", "reset_launch_counts"]
