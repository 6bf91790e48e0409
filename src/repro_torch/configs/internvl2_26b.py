"""InternVL2-26B [arXiv:2404.16821; hf]: InternViT frontend (STUB — the
assignment provides precomputed patch embeddings) + InternLM2-20B-class
LM backbone.  Backbone-only per the assignment."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553,
    mlp_kind="swiglu", rope_theta=1e6,
    input_kind="embeds",
    fsdp=True,            # 26B params: shard storage over data too
    microbatch=4,
)
