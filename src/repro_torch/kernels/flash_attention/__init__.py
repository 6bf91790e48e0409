from .kernel import (flash_attention_hopper,  # noqa: F401
                     flash_split_kv_hopper, launch_counts,
                     reset_launch_counts)
from .ops import flash_attention
from .ref import ref_attention, ref_split_kv

__all__ = ["flash_attention", "flash_attention_hopper",
           "flash_split_kv_hopper", "ref_attention", "ref_split_kv",
           "launch_counts", "reset_launch_counts"]
