"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf]: RG-LRU recurrent
blocks + local attention in a 2:1 pattern (26 layers = 8x(rec,rec,local)
+ (rec,rec) tail), MQA(kv=1), GeGLU."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000,
    pattern=("rec", "rec", "local"), tail=("rec", "rec"), window=2048,
    rnn_width=2560, conv_width=4,
    mlp_kind="geglu", scale_embed=True,
    microbatch=4,
)
