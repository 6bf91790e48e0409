"""Grok-1 314B [hf:xai-org/grok-1; unverified]: 64L, 8 experts top-2
(d_ff=32768), GQA(kv=8), attention + output logit softcaps, scaled
embeddings.  fsdp: 314B params must shard over data as well as model."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2,
    mlp_kind="swiglu", attn_softcap=30.0, logit_softcap=30.0,
    scale_embed=True,
    fsdp=True, microbatch=16,
)
