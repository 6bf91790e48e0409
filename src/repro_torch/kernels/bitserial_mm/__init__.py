from .kernel import (bitserial_matmul_planes,  # noqa: F401
                     bitserial_quant_matmul_hopper, launch_counts,
                     reset_launch_counts)
from .ops import bitserial_matmul, bitserial_quant_matmul
from .ref import (ref_bitserial_matmul, ref_bitserial_matmul_planes,
                  ref_bitserial_quant_matmul)

__all__ = ["bitserial_matmul", "bitserial_matmul_planes",
           "bitserial_quant_matmul", "bitserial_quant_matmul_hopper",
           "ref_bitserial_matmul", "ref_bitserial_matmul_planes",
           "ref_bitserial_quant_matmul", "launch_counts",
           "reset_launch_counts"]
