from .kernel import (QUANT_ROWS_BODIES,  # noqa: F401
                     bitserial_matmul_planes, bitserial_quant_matmul_hopper,
                     launch_counts, quant_rows_body, quant_rows_launch_args,
                     reset_launch_counts)
from .ops import bitserial_matmul, bitserial_quant_matmul
from .ref import (ref_bitserial_matmul, ref_bitserial_matmul_planes,
                  ref_bitserial_quant_matmul)

__all__ = ["bitserial_matmul", "bitserial_matmul_planes",
           "bitserial_quant_matmul", "bitserial_quant_matmul_hopper",
           "ref_bitserial_matmul", "ref_bitserial_matmul_planes",
           "ref_bitserial_quant_matmul", "quant_rows_body",
           "quant_rows_launch_args", "QUANT_ROWS_BODIES", "launch_counts",
           "reset_launch_counts"]
