"""Gemma2-2B [arXiv:2408.00118; hf]: alternating local(4096)/global
attention, GeGLU, attn+final logit softcaps, sandwich (post) norms,
sqrt(d)-scaled embeddings."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000,
    pattern=("local", "global"), window=4096,
    mlp_kind="geglu", attn_softcap=50.0, logit_softcap=30.0,
    post_norm=True, scale_embed=True,
    microbatch=4,
)
