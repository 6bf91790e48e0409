from .kernel import (fft_stage_hopper, fft_stages_hopper,  # noqa: F401
                     launch_counts, reset_launch_counts)
from .ops import fft_hopper, fft_stage
from .ref import (ref_fft, ref_fft_stage, ref_fft_stage_hopper,
                  ref_fft_stages_hopper)

__all__ = ["fft_stage", "fft_hopper", "fft_stage_hopper",
           "fft_stages_hopper", "ref_fft_stage", "ref_fft_stage_hopper",
           "ref_fft_stages_hopper", "ref_fft", "launch_counts",
           "reset_launch_counts"]
