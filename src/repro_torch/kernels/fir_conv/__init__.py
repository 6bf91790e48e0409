from .kernel import (fir_conv_hopper, launch_counts,  # noqa: F401
                     reset_launch_counts)
from .ops import fir_conv
from .ref import ref_fir, ref_fir_conv_hopper

__all__ = ["fir_conv", "fir_conv_hopper", "ref_fir", "ref_fir_conv_hopper",
           "launch_counts", "reset_launch_counts"]
