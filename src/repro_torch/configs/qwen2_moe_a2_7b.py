"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]: 60 routed experts
top-4 (d_ff=1408) + shared expert path (4 fused shared experts =
intermediate 5632) with sigmoid gate, MHA(kv=16)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=1, shared_ff=5632,
    mlp_kind="swiglu", microbatch=4,
)
