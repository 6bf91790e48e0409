"""StarCoder2-3B [arXiv:2402.19173; hf]: GQA(kv=2), RoPE, GELU MLP.
(Bias terms omitted repo-wide; DESIGN.md adaptation note.)"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152,
    mlp_kind="gelu", rope_theta=999999.0,
    microbatch=4,
)
