from .kernel import (launch_counts, reset_launch_counts,  # noqa: F401
                     shuffle_gemm_blocks, shuffle_gemm_grouped_blocks)
from .ops import shuffle_gemm, shuffle_gemm_grouped
from .ref import (ref_shuffle_gemm, ref_shuffle_gemm_blocks,  # noqa: F401
                  ref_shuffle_gemm_grouped_blocks)

__all__ = ["shuffle_gemm", "shuffle_gemm_grouped", "ref_shuffle_gemm",
           "ref_shuffle_gemm_blocks", "ref_shuffle_gemm_grouped_blocks",
           "shuffle_gemm_blocks", "shuffle_gemm_grouped_blocks",
           "launch_counts", "reset_launch_counts"]
