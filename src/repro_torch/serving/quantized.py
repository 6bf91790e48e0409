"""Weight quantization for serving — the SigDLA variable-bitwidth menu
(4/8/16-bit) applied to LLM weights; the port's counterpart of the JAX
package's ``serving/quantized.py``.

``quantize_tree`` stores every >=2-D weight as (int levels, per-output-
channel scale) through :func:`repro_torch.core.bitwidth.quantize`, bit for
bit the JAX package's; ``dequantize_tree`` is the storage-only mode (int
weights in memory, bf16 compute after dequant) that
``ServingEngine(quant_bits=...)`` uses.  As in the JAX package the
engine quantizes for storage only: it dequantizes, then runs float
GEMMs; no LLM weight takes the bitserial kernel.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..core import bitwidth as bw
from ..tree import tree_leaves, tree_map

__all__ = ["quantize_tree", "dequantize_tree", "quantized_bytes"]


def quantize_tree(params: Any, bits: int = 8,
                  min_size: int = 1 << 12) -> Tuple[Any, Any]:
    """Returns (q_tree, scale_tree); small/1-D/non-float leaves pass
    through (scale=None)."""
    def q(leaf):
        if leaf.ndim < 2 or leaf.numel() < min_size \
                or not leaf.is_floating_point():
            return leaf, None
        qv, scale = bw.quantize(leaf.float(), bits, axis=-2)
        store = torch.int8 if bits <= 8 else torch.int16
        return qv.to(store), scale

    pairs = [q(leaf) for leaf in tree_leaves(params)]
    it_q, it_s = iter(pairs), iter(pairs)
    qt = tree_map(lambda _: next(it_q)[0], params)
    st = tree_map(lambda _: next(it_s)[1], params)
    return qt, st


def dequantize_tree(q_tree: Any, scale_tree: Any,
                    dtype=torch.bfloat16) -> Any:
    def dq(q, s):
        if s is None:
            return q
        return (q.float() * s).to(dtype)
    return tree_map(dq, q_tree, scale_tree)


def quantized_bytes(q_tree: Any, scale_tree: Any, bits: int = 8) -> int:
    """Logical storage: quantized leaves at ``bits`` per element (int4
    levels pack two per byte on the wire/HBM), pass-through leaves at
    native width."""
    total = 0
    for q, s in zip(tree_leaves(q_tree), tree_leaves(scale_tree)):
        if s is None:
            total += q.numel() * q.element_size()
        else:
            total += (q.numel() * bits + 7) // 8 + s.numel() * s.element_size()
    return total
