from .kernel import (bitserial_matmul_planes, launch_counts,  # noqa: F401
                     reset_launch_counts)
from .ops import bitserial_matmul
from .ref import ref_bitserial_matmul, ref_bitserial_matmul_planes

__all__ = ["bitserial_matmul", "bitserial_matmul_planes",
           "ref_bitserial_matmul", "ref_bitserial_matmul_planes",
           "launch_counts", "reset_launch_counts"]
