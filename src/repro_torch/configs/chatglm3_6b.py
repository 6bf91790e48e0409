"""ChatGLM3-6B [arXiv:2406.12793; hf]: 2d-RoPE (rotary on half the head
dims), GQA(kv=2), SwiGLU."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=65024,
    mlp_kind="swiglu", rope_fraction=0.5,
    microbatch=4,
)
