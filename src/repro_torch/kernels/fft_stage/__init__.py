from .kernel import (fft_stage_hopper, launch_counts,  # noqa: F401
                     reset_launch_counts)
from .ops import fft_hopper, fft_stage
from .ref import ref_fft, ref_fft_stage, ref_fft_stage_hopper

__all__ = ["fft_stage", "fft_hopper", "fft_stage_hopper", "ref_fft_stage",
           "ref_fft_stage_hopper", "ref_fft", "launch_counts",
           "reset_launch_counts"]
